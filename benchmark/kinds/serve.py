"""The ``serve`` kind: one client in a closed loop calls ``segment(images)``
on host float32 batches in (−1, 1), each call on another batch of a pool
made from the seed, the labels back on the host every call.

The check: for calls sampled from the seed, the reference's logits for the
same images, and how far below the best class the served label's logit
lies.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.loops import Loop as Base
from benchmark.reference import model as ref


class Loop(Base):
    kind = "serve"

    def setup(self) -> None:
        mix = self.cell.mix
        gen = torch.Generator().manual_seed(self.seed)
        self.pool = [(torch.rand((self.batch, self.size, self.size, 3), generator=gen) * 2.0
                      - 1.0).numpy() for _ in range(int(mix["pool_batches"]))]
        self.phase("pool")
        self.weights = self.make_weights()
        self.phase("weights")
        self.build(self.weights)
        self.phase("program")
        self.warmup_s = []
        for i in range(int(mix["warmup_calls"])):
            t = time.perf_counter()
            self.seg.segment(self.pool[i % len(self.pool)])
            self.warmup_s.append(time.perf_counter() - t)
        self.keep_n = int(mix["checked_calls"])
        self.phase("warmup")

    def window(self, seconds: float) -> dict:
        rng = np.random.default_rng([self.seed, 1])
        kept, lat = [], []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with self.spans("window"):
            start = time.perf_counter()
            deadline = start + seconds
            i = 0
            while True:
                images = self.pool[i % len(self.pool)]
                with self.spans("segment"):
                    t = time.perf_counter()
                    labels = self.seg.segment(images)
                    lat.append(time.perf_counter() - t)
                # a uniform sample of the calls, drawn from the seed
                if i < self.keep_n:
                    kept.append((i, labels))
                else:
                    j = int(rng.integers(0, i + 1))
                    if j < self.keep_n:
                        kept[j] = (i, labels)
                i += 1
                if time.perf_counter() >= deadline:
                    break
            end = time.perf_counter()
        self.kept = kept
        self.latency = lat
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0
        window_s = end - start
        return {"units": i, "attempted": i, "failed": 0, "window_s": window_s,
                "memory_peak_bytes": peak,
                "metrics": {"serve_images_per_s": self.batch * i / window_s}}

    def check(self) -> dict:
        """The reference's logits for each sampled call's images: how far
        below the best class the served label's logit lies."""
        self.free()
        worst, calls = 0.0, []
        for i, labels in self.kept:
            gap = label_gap(self.arch, self.weights, self.pool[i % len(self.pool)], labels,
                            self.device)
            calls.append(i)
            worst = max(worst, gap)
        lat = np.array(self.latency) * 1e3
        chunks = np.array_split(lat, min(10, len(lat)))
        return {"numbers": {"label_gap": worst},
                "detail": {"calls_checked": calls,
                           "latency_ms": {"min": float(lat.min()),
                                          "p50": float(np.percentile(lat, 50)),
                                          "p90": float(np.percentile(lat, 90)),
                                          "p99": float(np.percentile(lat, 99)),
                                          "median_by_tenth": [float(np.median(c)) for c in chunks]}}}


@torch.no_grad()
def label_gap(arch: ref.Arch, weights: dict, images: np.ndarray, labels: np.ndarray,
              device) -> float:
    """max over pixels of (the reference's best logit − its logit of the
    served label), over the logits' root mean square."""
    x = torch.as_tensor(images, device=device)
    logits, up = ref.logits(ref.Run(weights, train=False), arch, x)
    logits = ref.upsample(logits, up)
    served = torch.as_tensor(labels, device=device).long()
    if served.shape != (logits.shape[0],) + logits.shape[2:]:
        raise ValueError(f"labels {tuple(served.shape)} for logits {tuple(logits.shape)}")
    if int(served.min()) < 0 or int(served.max()) >= logits.shape[1]:
        return float("inf")
    best = logits.max(1).values
    at = logits.gather(1, served[:, None])[:, 0]
    return float((best - at).max() / logits.square().mean().sqrt())
