"""Where the device time of one dpm++ request goes, on a CUDA card.

    python3 -m tmdiff_tpu_torch.profile_request [--bands 8|4] [--impl banded|auto]

Builds the full-width WavBEST (channels 32, 64, 128, 256) from a seed with
the given 3x3x3 conv lowering (ops/modconv.py), warms up with one request
(batch 2, 256x256), then runs one under
torch.profiler and prints the request's wall seconds, the device's busy
share (summed kernel time over wall time) and the kernel time by group and
by name. fp32, TF32 off.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops.modconv import IMPLS
from tmdiff_tpu_torch.pipeline import Pansharpener

BATCH, SIZE, SEED = 2, 256, 0
GROUPS = (("conv_3x3 kernel (K1, K3)", ("conv_3x3_kernel",)),
          ("matmul (1x1x1 convs, Linear)", ("gemm", "cutlass", "cublas")),
          ("sort (quantile)", ("sort", "radix")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, copies, reductions)"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bands", type=int, choices=(8, 4), default=8)
    parser.add_argument("--impl", choices=IMPLS, default="banded")
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(SEED)
    ms = rng.uniform(0.05, 0.95, (BATCH, args.bands, SIZE, SIZE)).astype(np.float32)
    batch = {"PAN": ms.mean(1, keepdims=True), "MS": ms}
    sensor = "WV3" if args.bands == 8 else "QB"
    sharp = Pansharpener(WavBEST(seed=SEED).use_conv_impl(args.impl))
    sharp.sample(batch, sensor=sensor, seed=SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharp.sample(batch, sensor=sensor, seed=SEED)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)
    by_group: dict[str, float] = {}
    for e in kernels:
        by_group[group_of(e.key)] = by_group.get(group_of(e.key), 0.0) + e.self_device_time_total
    print(f"{smi}; request {sensor} {args.bands}-band batch {BATCH} {SIZE}x{SIZE}, "
          f"{args.impl} convs: "
          f"wall {wall:.3f} s under the profiler, device kernel time {total_us / 1e6:.3f} s, "
          f"busy share {total_us / 1e6 / wall:.3f}")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {us / 1e6:.3f} s ({us / total_us:.3f} of kernel time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.1f} ms {e.count:6d} calls  {e.key[:100]}")


if __name__ == "__main__":
    main()
