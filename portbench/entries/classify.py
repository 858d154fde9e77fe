"""Bulk 1-NN classification under symmetric PQDTW (paper, section 4.1)
through ``repro_torch.core.knn.knn_classify_sym``.

Set-up makes the training set and ``pool_sets`` test sets on the device
from the seed, pre-aligns the training set with the program, takes ``K``
training segments a subspace (rows drawn from the seed) as centroids,
builds the codebook (``pq.codebook_from_centroids``) and encodes the
training set, then classifies one test set to build and warm every
kernel.  The window is a closed loop with one batch in flight: each
batch is a whole test set, taken in turn from the pool, and its labels
are read back to the host.  The labels handed to the program are the
training rows' indices, so each answer names the neighbour it chose;
the class follows from it.

``correct``: every batch's answers against the reference's ADC
distances of that test set (``nn_gap``, reference/checks.py).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..reference.checks import nn_gap
from ..reference.classify import Classifier
from ..reference.geometry import pq_geometry
from ..roofline import classify_step
from ..series import generator, make_series

__all__ = ["Cell", "centroid_rows", "pq_config"]


def centroid_rows(seed: int, n_train: int, M: int, K: int, device
                  ) -> torch.Tensor:
    """``(M, K)`` distinct training rows a subspace, drawn from the seed."""
    g = generator(seed, "centroids", device)
    return torch.stack([torch.randperm(n_train, generator=g,
                                       device=device)[:K]
                        for _ in range(M)])


def pq_config(pq: dict):
    from repro_torch.core.pq import PQConfig
    return PQConfig(n_sub=pq["n_sub"], codebook_size=pq["codebook_size"],
                    window_frac=pq["window_frac"], metric=pq["metric"],
                    use_prealign=pq["use_prealign"],
                    wavelet_level=pq["wavelet_level"],
                    tail_frac=pq["tail_frac"],
                    refine_frac=pq["refine_frac"])


class Cell:
    unit = "series"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        ds = config["dataset"]
        self.D, self.n_train, self.n_test = (ds["length"], ds["n_train"],
                                             ds["n_test"])
        self.geo = pq_geometry(config["pq"], self.D)
        self.pool_sets = int(traffic["pool_sets"])
        self.answers: List[Tuple[int, torch.Tensor]] = []
        self.batch_times: List[Tuple[float, float]] = []
        self.failed_batches = 0
        self.error: Optional[str] = None

    # -- inputs ---------------------------------------------------------------

    def _data(self, name: str, n: int) -> torch.Tensor:
        ds = self.config["dataset"]
        X, _ = make_series(n, self.D, ds["classes"], ds["noise"],
                           generator(self.seed, name, self.device),
                           self.device)
        return X

    def make_inputs(self) -> None:
        self.train = self._data("train", self.n_train)
        self.tests = [self._data(f"test/{p}", self.n_test)
                      for p in range(self.pool_sets)]
        self.rows = centroid_rows(self.seed, self.n_train, self.geo.M,
                                  self.geo.K, self.device)

    # -- the program ------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.core import knn, pq
        self.make_inputs()
        self.pcfg = pq_config(self.config["pq"])
        segs = pq.segment(self.train, self.pcfg)
        cents = torch.stack([segs[self.rows[m], m]
                             for m in range(self.geo.M)]).contiguous()
        self.cb = pq.codebook_from_centroids(cents, self.pcfg, self.D)
        self.train_codes = pq.encode(self.train, self.cb, self.pcfg,
                                     device=self.device)
        self.train_ids = torch.arange(self.n_train, device=self.device)
        self._knn = knn.knn_classify_sym
        self.warm()

    def warm(self) -> None:
        self.launch(0).cpu()

    def launch(self, p: int) -> torch.Tensor:
        """Classify test set ``p``; the labels stay on the device."""
        return self._knn(self.train_codes, self.train_ids, self.tests[p],
                         self.cb, self.pcfg, device=self.device)

    def run_window(self, seconds: float, tracer) -> None:
        self.t0 = time.perf_counter()
        deadline = self.t0 + seconds
        i = 0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            tracer.tick(now)      # between whole batches
            # the batch starts after the tick, which may open the slice
            start = time.perf_counter()
            p = i % self.pool_sets
            try:
                self.answers.append((p, self.launch(p).cpu()))
            except Exception as e:           # noqa: BLE001 - counted
                self.failed_batches += 1
                self.error = f"{type(e).__name__}: {e}"
            self.batch_times.append((start, time.perf_counter()))
            i += 1
        self.t_end = time.perf_counter()
        tracer.finish()

    def release(self) -> None:
        for name in ("cb", "train_codes", "train_ids", "_knn"):
            self.__dict__.pop(name, None)

    # -- results -----------------------------------------------------------------

    def attempted(self) -> int:
        return len(self.batch_times) * self.n_test

    def failed(self) -> int:
        return self.failed_batches * self.n_test

    def end_to_end(self) -> Dict[str, float]:
        done = len(self.answers) * self.n_test
        return {"classify_series_per_s": done / (self.t_end - self.t0)}

    def check(self, answers=None) -> Dict[str, float]:
        """The compared numbers: every batch's answers (or ``answers``,
        another side's, such as the control's) against the reference's
        ADC distances of its test set."""
        answers = self.answers if answers is None else answers
        ref = Classifier(self.train, self.rows, self.geo)
        gap = 0.0
        for p in sorted({p for p, _ in answers}):
            d = ref.distances(self.tests[p])
            for q, chosen in answers:
                if q == p:
                    gap = max(gap, nn_gap(d, chosen))
            del d
        return {"nn_gap": gap}

    def control_answers(self, dtype: torch.dtype):
        """The reference in ``dtype``, put in the program's place: one
        answer for each test set of the pool (every set a window
        reaches)."""
        ctl = Classifier(self.train, self.rows, self.geo, dtype)
        return [(p, ctl.nearest(self.tests[p]).cpu())
                for p in range(self.pool_sets)]

    # -- what the readers get -------------------------------------------------

    def reader_stats(self, tracer) -> dict:
        g = self.geo
        step = classify_step(self.n_test, self.n_train, g.D, g.M, g.K, g.S,
                             g.window, g.refine_t, g.level)
        stats = {"step": step, "n_test": self.n_test,
                 "n_train": self.n_train}
        if tracer.slice_host is not None:
            a, b = tracer.slice_host
            stats["slice_batches"] = sum(1 for s, e in self.batch_times
                                         if s >= a and e <= b)
        start = tracer.prof_host[0] if tracer.prof_host else self.t_end
        before = [(s, e) for s, e in self.batch_times if e <= start]
        if before:
            stats["plain_batches"] = len(before)
            stats["plain_s"] = before[-1][1] - self.t0
        return stats
