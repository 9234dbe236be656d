"""Where the device time of one sampling request goes, on a CUDA card.

    python3 -m tmdiff_tpu_torch.profile_request [--bands 8|4] [--impl banded|auto]
        [--method dpm++|ancestral|...] [--batch 2] [--size 256] [--n-timestep 1000] [--bf16]

Builds the full-width WavBEST (channels 32, 64, 128, 256) from a seed with
the given 3x3x3 conv lowering (ops/modconv.py), warms up with one request
(`dpm++`, batch 2, 256x256 unless told otherwise), times one without the
profiler (host clock to a synchronize), then runs one under
torch.profiler and prints the request's wall seconds, its denoise calls,
the device's busy share (the union of its operations' intervals over the
wall time, so that operations that overlap count once) and the kernel time
by group and by name. fp32, TF32 off; `--bf16` runs the same request
on `WavBEST(dtype=torch.bfloat16)`, whose convs take the bf16 instances.
`--n-timestep` sets the schedule's T, which is the ancestral sampler's step
count.
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
from tmdiff_tpu_torch.pipeline import METHODS, Pansharpener

SEED = 0
GROUPS = (("conv_3x3 kernels (K1, K3: tensor-core or FMA variant, weight split, "
           "split-K reduce)", ("conv_3x3_",)),
          ("matmul (1x1x1 convs, Linear)", ("gemm", "cutlass", "cublas")),
          ("sort (quantile)", ("sort", "radix")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, copies, reductions)"


def busy_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bands", type=int, choices=(8, 4), default=8)
    parser.add_argument("--impl", choices=IMPLS, default="banded")
    parser.add_argument("--method", choices=METHODS, default="dpm++")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--n-timestep", type=int, default=1000)
    parser.add_argument("--bf16", action="store_true", help="the model in bfloat16")
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(SEED)
    ms = rng.uniform(0.05, 0.95, (args.batch, args.bands, args.size, args.size))
    ms = ms.astype(np.float32)
    batch = {"PAN": ms.mean(1, keepdims=True), "MS": ms}
    sensor = "WV3" if args.bands == 8 else "QB"
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = WavBEST(seed=SEED, dtype=dtype).use_conv_impl(args.impl)
    sharp = Pansharpener(model, n_timestep=args.n_timestep)
    sharp.sample(batch, sensor=sensor, method=args.method, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharp.sample(batch, sensor=sensor, method=args.method, seed=SEED)
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    calls, denoise = [], model._denoise_impl

    def counted(*a, **kw):
        calls.append(1)
        return denoise(*a, **kw)

    # counts the profiled request's denoise calls: denoise, denoise_deep and
    # denoise_reuse all run the shared body
    model._denoise_impl = counted
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharp.sample(batch, sensor=sensor, method=args.method, seed=SEED)
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in prof.events()
                        if e.device_type == cuda) / 1e6
    by_group: dict[str, float] = {}
    for e in kernels:
        by_group[group_of(e.key)] = by_group.get(group_of(e.key), 0.0) + e.self_device_time_total
    print(f"{smi}; {args.method} request {sensor} {args.bands}-band batch {args.batch} "
          f"{args.size}x{args.size}, {args.impl} convs, {str(dtype)[6:]}, {len(calls)} denoise "
          f"calls: wall {unprofiled:.3f} s without the profiler, {wall:.3f} s under it; device "
          f"kernel time {total_us / 1e6:.3f} s, busy {busy:.3f} s: busy share {busy / wall:.3f} "
          f"under the profiler, {busy / unprofiled:.3f} of the unprofiled wall; "
          f"{len(kernels)} kernel names, "
          f"{sum(e.count for e in kernels)} kernel launches")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {us / 1e6:.3f} s ({us / total_us:.3f} of kernel time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.1f} ms {e.count:6d} calls  {e.key[:100]}")


if __name__ == "__main__":
    main()
