"""The FLOP and byte counters against hand counts on small shapes."""
import pytest
import torch

from portbench import counts, spec

torch.set_num_threads(2)
CH = (8, 16, 16, 32)
CFG = {"channel_multiplier": list(CH), "embed_dim": 128, "inter_dim": 32, "n_timestep": 1000}
FAMILY = spec.load("wavbest-bf16.serve-quality").family


def conv3_shapes(bands, size):
    """(Cin, Cout, H) of every SAME 3x3x3 conv of one encode and of one
    full and one level-3 reuse denoise call of WavBEST at widths CH, by
    hand from the model's structure."""
    c0, c1, c2, c3 = CH
    s0, s1, s2, s3 = size, size // 2, size // 4, size // 8
    enc = [(c0, c0, s0)]                                     # conv1's modulated conv
    for cin, f, s in ((c0, c1, s0), (c1, c2, s1), (c2, c3, s2)):
        enc += [(cin, f, s), (f, f, s), (f, f, s), (f, f, s // 2)]  # ResBlock 2, Conv_0, Conv_1
    shallow = [(c0, c0, s0)] + [(c0, c1, s0), (c1, c1, s0), (c1, c1, s0), (c1, c1, s1)]
    deep = [(c1, c2, s1), (c2, c2, s1), (c2, c2, s1), (c2, c2, s2),   # down2
            (c2, c3, s2), (c3, c3, s2), (c3, c3, s2), (c3, c3, s3),   # down3
            (c3, c3, s3), (c3, c3, s3)]                               # middle1

    def up(cin, f, skip, s):  # ResBlock, Conv_0, convH (3 groups), Conv_1; output at 2s
        return [(cin, f, s), (f, f, s), (f, f, s)] + [(skip, f, s)] * 3 + [(f, f, 2 * s)]

    ups12 = up(3 * c3, c2, c3, s3) + up(3 * c2, c1, c2, s2)
    up3 = up(3 * c1, c0, c1, s1)
    final = [(3 * c0, c0, s0), (c0, c0, s0)] + [(c0, c0, s0)] * 6
    return enc, shallow + deep + ups12 + up3 + final, shallow + up3 + final


def flops(shapes, b, bands):
    """Valid taps only: 3n - 2 of the 3n taps along an axis of n positions."""
    return sum(2 * b * (3 * bands - 2) * (3 * h - 2) ** 2 * cin * cout
               for cin, cout, h in shapes)


def padded_flops(shapes, b, bands):
    """The whole 27-tap kernel at every output, as torch's counter counts a conv."""
    return sum(2 * b * bands * h * h * 27 * cin * cout for cin, cout, h in shapes)


def test_conv_work_hand_count():
    work = counts.ConvWork(2)
    x = torch.empty(2, 16, 4, 8, 8, device="meta")
    w = torch.empty(32, 16, 3, 3, 3, device="meta")
    work("conv3", x, w, True, False)
    work("conv1", x, torch.empty(32, 16, 1, 1, 1, device="meta"))
    assert work.convs == 1
    # depth 4: 10 of 12 taps inside; 8 positions: 22 of 24
    assert work.flops == 2 * 2 * 16 * 32 * 10 * 22 * 22
    assert work.bytes == 2 * (x.numel() + w.numel() + 2 * 4 * 8 * 8 * 32 + 2 * 16)


@pytest.mark.parametrize("method,steps,kw", [
    ("ddim", 1, None), ("ddim_cached", 4, {"refresh_every": 2, "cache_level": 3})])
def test_serve_batch_k1_work(method, steps, kw):
    traffic = {"bands": 4, "size": 32,
               "engine": {"method": method, "steps": steps, "sampler_kw": kw}}
    got = counts.serve_batch(FAMILY, CFG, traffic, bucket=2, elem_bytes=2)
    enc, full, reuse = conv3_shapes(4, 32)
    n_full = steps if method == "ddim" else steps // 2
    n_reuse = steps - n_full
    assert got["k1_convs"] == len(enc) + n_full * len(full) + n_reuse * len(reuse)
    # the model's 57 SAME 3x3x3 convs (65 launches: a concat's parts launch apart)
    assert len(enc) + len(full) == 57
    assert got["k1_flops"] == (flops(enc, 2, 4) + n_full * flops(full, 2, 4)
                               + n_reuse * flops(reuse, 2, 4))
    assert got["model_flops"] > got["k1_flops"]


def test_train_step_counts_forward_and_both_gradients():
    got = counts.train_step(FAMILY, CFG, {"batch": 2, "size": 16}, bands=4, elem_bytes=4)
    enc, full, _ = conv3_shapes(4, 16)
    assert got["k1_flops"] == 2 * flops(enc + full, 2, 4) and got["k1_convs"] == 2 * 57
    # forward, input and weight gradients of every conv: at least three times
    # the 3x3x3 forward, the input gradient of the first 1x1x1 convs left out
    fwd = padded_flops(enc + full, 2, 4)
    assert 3 * fwd < got["model_flops"] < 3.2 * fwd
