"""What one run measured, as the metric readers (portbench/metrics/*.py)
read it. Every time is on the wall clock in nanoseconds; the window is the
measured one: [start, start + run seconds) for a serve mix, whose requests
are due in it, and from the first step to the synchronize after the last
for a training mix."""
from __future__ import annotations

import dataclasses
from typing import Optional

from portbench import counts
from portbench.trace import Spans


@dataclasses.dataclass
class Record:
    cell: object  # spec.Cell
    setup_s: float
    start: int = 0
    end: int = 0
    # serve: [{"due", "done" (None: never resolved), "ok"}], the engine's
    # counters over the window
    requests: list = dataclasses.field(default_factory=list)
    engine_delta: dict = dataclasses.field(default_factory=dict)
    # serve: [{"start", "end", "bucket"}] of every sampler call
    batches: list = dataclasses.field(default_factory=list)
    # train: the band count of each step of the window
    steps: list = dataclasses.field(default_factory=list)
    spans: Spans = dataclasses.field(default_factory=Spans)
    kernels: Optional[object] = None  # the device trace (trace.Kernels); None untraced
    failed: int = 0  # train: steps of the window whose loss was not finite
    backlog: int = 0  # serve: requests still queued when the window closed
    _work: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def peak_flops(self) -> float:
        return float(self.cell.config["peak_flops"])

    @property
    def peak_bytes(self) -> float:
        return float(self.cell.config["peak_bytes_per_s"])

    @property
    def elem_bytes(self) -> int:
        return {"bfloat16": 2, "float32": 4}[self.cell.config["model"]["dtype"]]

    def serve_work(self, bucket: int) -> dict:
        """The counted work of one served batch of `bucket` rows."""
        if ("serve", bucket) not in self._work:
            self._work["serve", bucket] = counts.serve_batch(
                self.cell.family, self.cell.config["model"], self.cell.traffic, bucket,
                self.elem_bytes)
        return self._work["serve", bucket]

    def train_work(self, bands: int) -> dict:
        """The counted work of one training step on `bands`-band images."""
        if ("train", bands) not in self._work:
            self._work["train", bands] = counts.train_step(
                self.cell.family, self.cell.config["model"], self.cell.traffic, bands,
                self.elem_bytes)
        return self._work["train", bands]

    def batches_inside(self) -> list:
        """The sampler calls that began and ended inside the window."""
        return [b for b in self.batches if b["start"] >= self.start and b["end"] <= self.end]

    def kernel_seconds(self, names, spans=None) -> float:
        """Device seconds of the traced operations whose name holds one of
        `names`, inside the window, or inside one of `spans` ((a, b) ns)."""
        return self.kernels.seconds_within(names, [(self.start, self.end)] if spans is None
                                           else spans)
