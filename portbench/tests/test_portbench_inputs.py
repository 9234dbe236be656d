"""The traffic generator: determinism, the arrivals' gaps, the sensor
ratios, the training mix's blocks and batch order, the weights."""
import numpy as np
import pytest
import torch

from portbench import inputs, spec

torch.set_num_threads(2)
WAVBEST = spec.load("wavbest-fp32.train-joint").family


def test_arrivals_same_seed_same_schedule():
    a = inputs.arrivals(5.6, 30.0, 2**31 + 11)
    b = inputs.arrivals(5.6, 30.0, 2**31 + 11)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("rate,seconds", [(5.6, 30.0), (100.0, 30.0), (0.5, 10.0),
                                          (96.0, 45.0)])
def test_arrivals_every_seed_gets_the_same_gaps(rate, seconds):
    n = int(round(rate * seconds))
    gap_sets = []
    for seed in (1, 2, 3 * 10**9):
        due = inputs.arrivals(rate, seconds, seed)
        assert len(due) == n and due[0] == 0.0
        assert np.all(np.diff(due) > 0) and due[-1] < seconds
        gaps = np.append(np.diff(due), seconds - due[-1])
        assert gaps.sum() == pytest.approx(seconds)
        gap_sets.append(np.sort(gaps))
    assert np.allclose(gap_sets[0], gap_sets[1]) and np.allclose(gap_sets[0], gap_sets[2])
    assert not np.array_equal(inputs.arrivals(rate, seconds, 1),
                              inputs.arrivals(rate, seconds, 2))


def test_arrivals_look_exponential():
    due = inputs.arrivals(100.0, 30.0, 5)
    gaps = np.diff(due)
    # the exponential's coefficient of variation is 1, its median ln 2 of the mean
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.05)
    assert np.median(gaps) / gaps.mean() == pytest.approx(np.log(2), abs=0.03)


@pytest.mark.parametrize("weights,n", [({"WV3": 1, "WV2": 1}, 168),
                                       ({"QB": 1, "GF2": 1, "WV4": 1}, 2401),
                                       ({"QB": 4, "GF2": 4, "WV3": 8}, 7)])
def test_assign_keeps_the_ratio(weights, n):
    got = inputs.assign(weights, n, 9, 2)
    assert len(got) == n
    total = sum(weights.values())
    for k, w in weights.items():
        assert abs(got.count(k) - n * w / total) < 1
    assert got == inputs.assign(weights, n, 9, 2)


def test_serve_requests_are_the_seeds():
    t = {"rate_per_s": 5.6, "sensors": {"WV3": 1, "WV2": 1}, "pool": 16}
    a = inputs.serve_requests(t, 30.0, 77)
    assert a == inputs.serve_requests(t, 30.0, 77)
    assert a != inputs.serve_requests(t, 30.0, 78)
    assert all(0 <= i < 16 for _, _, i in a)


def test_block_draw_holds_the_published_ratio_in_every_block():
    block = ["QB", "GF2", "WV3", "WV3"]
    draw = inputs.BlockDraw(["QB", "GF2", "WV3"], block, 2**31 + 3)
    seq = [draw.sensors[draw.choice(3, p=None)] for _ in range(40)]
    for k in range(10):
        assert sorted(seq[4 * k:4 * k + 4]) == sorted(block)
    assert len({tuple(seq[4 * k:4 * k + 4]) for k in range(10)}) > 1
    assert np.allclose(draw.probabilities(), [0.25, 0.25, 0.5])


def test_block_draw_drives_the_ports_sensor_mixer():
    from tmdiff_tpu_torch.data.pipeline import BatchIterator, SensorMixer

    pools = {s: inputs.Pool(inputs.scene_pool(3, 10 + i, 16, b, 16))
             for i, (s, b) in enumerate((("QB", 4), ("GF2", 4), ("WV3", 8)))}
    iters = {s: BatchIterator(p, 4, seed=21) for s, p in pools.items()}
    mixer = SensorMixer(iters, weights={"QB": 4, "GF2": 4, "WV3": 8}, seed=21)
    draw = inputs.BlockDraw(mixer.sensors, ["QB", "GF2", "WV3", "WV3"], 21)
    assert np.allclose(mixer.probs, draw.probabilities())
    mixer.rng = draw
    got = [next(mixer) for _ in range(9)]
    want = inputs.train_batches({"sensors": {"QB": 4, "GF2": 4, "WV3": 8}, "batch": 4,
                                 "block": ["QB", "GF2", "WV3", "WV3"]}, pools, 21, 9)
    for (batch, sensor), (sensor_w, batch_w) in zip(got, want):
        assert sensor == sensor_w
        for k in ("Res", "PAN", "MS"):
            assert np.array_equal(batch[k], batch_w[k])


def test_batch_order_is_the_ports_batch_iterator():
    from tmdiff_tpu_torch.data.pipeline import BatchIterator

    class Rows:
        def __len__(self):
            return 20

        def batch(self, idx):
            return np.asarray(idx)

    it = BatchIterator(Rows(), 8, seed=5)
    for got, want in zip(inputs.batch_order(20, 8, 5, 7), (next(it) for _ in range(7))):
        assert np.array_equal(got, want)


def test_weights_are_the_seeds_and_at_their_scale():
    spec = WAVBEST.weight_spec({"channel_multiplier": [8, 16, 16, 32], "embed_dim": 128,
                                "inter_dim": 32})
    a = inputs.make_weights(spec, 2**31 + 1, "cpu")
    b = inputs.make_weights(spec, 2**31 + 1, "cpu")
    c = inputs.make_weights(spec, 2**31 + 2, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["down1.conv20.conv20.weight"], c["down1.conv20.conv20.weight"])
    w = a["up1.conv20.conv20.weight"]  # (3, 3, 3, 96, 16): fan-in 27 * 96
    assert float(w.std()) == pytest.approx((27 * 96) ** -0.5, rel=0.05)
    assert float(a["final.dense2.dense.bias"].mean()) == pytest.approx(1.0, abs=0.02)
    assert float(a["embed.0.bias"].abs().max()) < 0.1


def test_prompt_table_rows_depend_on_the_name_alone():
    t1 = inputs.prompt_table(["QB", "WV3"])
    t2 = inputs.prompt_table(["WV3", "QB", "GF2"])
    assert np.array_equal(t1[0], t2[1]) and np.array_equal(t1[1], t2[0])
    assert np.sqrt((t1 ** 2).mean(1)) == pytest.approx(1.0, abs=1e-5)


def test_scene_pool_is_the_ports_scene():
    from tmdiff_tpu_torch.data.synthetic import make_scene

    pool = inputs.scene_pool(8, 4, 2, 4, 32)
    rng = np.random.default_rng([8, 4])
    for i in range(2):
        gt, _, lms, pan = make_scene(rng, 4, 32)
        assert np.array_equal(pool["gt"][i], gt) and np.array_equal(pool["lms"][i], lms)
        assert np.array_equal(pool["pan"][i], pan)


@pytest.mark.parametrize("rate,seconds", [(5.4, 45.0), (96.0, 45.0)])
def test_arrivals_keep_a_poisson_processs_bursts(rate, seconds):
    """A plain shuffle: the load of 16 successive gaps spreads as a Poisson
    process's does (a quarter of its mean), not evened out."""
    for seed in (1, 2**31 + 9):
        gaps = np.diff(np.append(inputs.arrivals(rate, seconds, seed), seconds))
        n = len(gaps) // 16 * 16
        sums = gaps[:n].reshape(-1, 16).sum(1)
        assert 0.15 < sums.std() / sums.mean() < 0.35
        assert sums.mean() == pytest.approx(16 / rate, rel=0.1)
