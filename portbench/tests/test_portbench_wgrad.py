"""The weight gradient's roofline share, on records made by hand: half the
step's K1 work over the device time of every kernel with `wgrad` in its
name, cuDNN's or the port's, and nothing where no such kernel ran."""
import pytest

from portbench import spec
from portbench.record import Record
from portbench.trace import Kernels

TRAIN = "wavbest-fp32.train-joint"


def _record(kernels):
    cell = spec.load(TRAIN)
    rec = Record(cell, 20.0, start=0, end=int(3e9))
    rec.steps = [8, 4, 8]
    work = {8: {"k1_flops": 495e12 * 0.02, "k1_bytes": 0.0},
            4: {"k1_flops": 1.0, "k1_bytes": 3.35e12 * 0.01}}
    rec.train_work = work.__getitem__
    rec.kernels = Kernels.of(kernels)
    return cell, rec


@pytest.mark.parametrize("names", [
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc",
     "wgrad_alg1_nd_float_engine<float, 3, 1, 1>"),
    ("void (anonymous namespace)::wgrad_3x3_tf32x3_kernel<32>(CUtensorMap_st, ...)",
     "void (anonymous namespace)::wgrad_splitk_reduce_kernel(const float *, ...)"),
], ids=["cudnn", "port"])
def test_wgrad_roofline_reads_either_implementation(names):
    # 0.4 s and 0.1 s of weight-gradient kernels; K1's and others' not counted
    cell, rec = _record([(names[0], 0, int(0.4e9)), (names[1], int(0.4e9), int(0.5e9)),
                         ("conv_3x3_tf32x3_kernel<3,128>", int(0.5e9), int(0.9e9)),
                         ("elementwise", int(0.9e9), int(1e9))])
    # least time: two 8-band steps at 0.01 s (operations), one 4-band at 0.005 s (bytes)
    assert cell.reader("wgrad_roofline.train").read(rec) == pytest.approx(100 * 0.025 / 0.5)


def test_wgrad_roofline_counts_cudnns_layout_transposes():
    cell, rec = _record([
        ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc", 0, int(0.4e9)),
        ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float, true>",
         int(0.4e9), int(0.45e9)),
        ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false>",
         int(0.45e9), int(0.5e9))])
    assert cell.reader("wgrad_roofline.train").read(rec) == pytest.approx(100 * 0.025 / 0.5)


def test_wgrad_roofline_without_its_kernels_reads_nothing():
    cell, rec = _record([("conv_3x3_tf32x3_kernel<3,128>", 0, int(1e9))])
    assert cell.reader("wgrad_roofline.train").read(rec) is None
    rec.kernels = None
    assert cell.reader("wgrad_roofline.train").read(rec) is None
