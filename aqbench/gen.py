"""Frozen input generators: guest images, dedup variants, versions, picks.

Copies of the generators the port's chip smoke uses (``make_image``,
``make_variant``), kept here so that a later change to the program cannot
move the benchmark's inputs.  Everything is drawn from the run's seed: the
layouts, the bytes, the targets and the guest's touches.  The same seed
gives the same inputs, on the card or on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

PAGE = 4096
MASK63 = (1 << 63) - 1


def sub_seed(seed: int, *parts: int) -> int:
    """A seed for one part of the run (a function, a variant, a version),
    derived from the run's seed: any whole number, large ones included."""
    s = int(seed) & MASK63
    for p in parts:
        s = (s * 1_000_003 + 7919 * (int(p) + 1)) & MASK63
    return s


def make_image(n_pages: int, mix: dict, seed: int, device) -> tuple:
    """``(buf uint8[n_pages * PAGE], hot bool[n_pages])`` on ``device``: the
    paper's page mix (Fig. 3), as the configuration's ``page_mix`` gives it:
    alternating zero and cold regions of geometric lengths (means
    ``zero_region_mean_pages`` and ``cold_region_mean_pages``) with hot runs
    (geometric, mean ``hot_run_mean_pages``, started at random so that
    ``hot_share`` of the pages are hot before overlaps merge) laid over them;
    non-zero pages hold random bytes.  Layout and bytes come from ``seed``."""
    zero_mean = float(mix["zero_region_mean_pages"])
    cold_mean = float(mix["cold_region_mean_pages"])
    run_mean = float(mix["hot_run_mean_pages"])
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 0))
    n_reg = int(n_pages / (zero_mean + cold_mean) * 1.5) + 64
    lens = torch.empty(2 * n_reg, device=device)
    lens[0::2].geometric_(1 / zero_mean, generator=g)
    lens[1::2].geometric_(1 / cold_mean, generator=g)
    bounds = torch.cumsum(lens.long(), 0)
    if int(bounds[-1]) < n_pages:
        raise RuntimeError("region draw too short for the image")
    pages = torch.arange(n_pages, device=device)
    zero_region = torch.searchsorted(bounds, pages, right=True) % 2 == 0
    n_hot_runs = max(1, round(float(mix["hot_share"]) * n_pages / run_mean))
    starts = torch.randint(0, n_pages, (n_hot_runs,), generator=g, device=device)
    run_len = torch.empty(n_hot_runs, device=device).geometric_(1 / run_mean, generator=g).long()
    delta = torch.zeros(n_pages + 1, dtype=torch.long, device=device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, (starts + run_len).clamp(max=n_pages), -torch.ones_like(starts))
    hot = torch.cumsum(delta, 0)[:n_pages] > 0
    g.manual_seed(sub_seed(seed, 1))
    buf = torch.randint(0, 256, (n_pages * PAGE,), dtype=torch.uint8, generator=g,
                        device=device)
    buf.view(n_pages, PAGE)[zero_region & ~hot] = 0
    return buf, hot


def page_classes(buf: torch.Tensor, hot: torch.Tensor) -> tuple:
    """``(hot_pages, cold_pages)`` as sorted int64 tensors on the image's
    device: hot = working set minus zero pages, cold = the other non-zero
    pages (the paper's classes, worked out from the bytes)."""
    nonzero = buf.view(-1, PAGE).any(dim=1).to(torch.bool)   # any() of uint8 is uint8
    return (torch.nonzero(nonzero & hot).view(-1),
            torch.nonzero(nonzero & ~hot).view(-1))


def fill_rows(buf: torch.Tensor, rows: torch.Tensor, seed: int) -> None:
    """Random bytes from ``seed`` into the pages ``rows`` of ``buf``."""
    if not rows.numel():
        return
    g = torch.Generator(device=buf.device)
    g.manual_seed(seed)
    buf.view(-1, PAGE)[rows] = torch.randint(0, 256, (rows.numel(), PAGE), dtype=torch.uint8,
                                             generator=g, device=buf.device)


def delta_pages(n_hot: int, per_256: int) -> int:
    """Hot pages a variant (or a version) owns alone: round(n_hot * r / 256)."""
    return round(n_hot * per_256 / 256)


def delta_rows(hot_t: torch.Tensor, d: int, v: int) -> torch.Tensor:
    """The hot pages variant ``v`` owns alone: ``d`` of them from rank
    ``v * d``, wrapping around the hot set (``dedup_bench.make_fleet``)."""
    n = int(hot_t.numel())
    if not n or not d:
        return hot_t[:0]
    ranks = (v * d + torch.arange(d, device=hot_t.device)) % n
    return hot_t[ranks]


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


class Picks:
    """One client's stream of targets, drawn from the run's seed: Zipf(s)
    over ``n`` targets (which target holds which rank is itself drawn), or a
    permutation of them taken round after round ("cycle")."""

    def __init__(self, n: int, dist: str, s: float, seed: int, client: int):
        if dist not in ("zipf", "cycle"):
            raise ValueError(f"unknown pick distribution {dist!r}")
        self.n, self.dist = n, dist
        self.rng = np.random.default_rng([int(seed) & MASK63, 17, int(client)])
        self.p = None
        if dist == "zipf":
            rank_of = np.random.default_rng([int(seed) & MASK63, 19]).permutation(n)
            self.p = zipf_weights(n, s)[rank_of]
        self._round: list = []

    def next(self) -> int:
        if self.dist == "zipf":
            return int(self.rng.choice(self.n, p=self.p))
        if not self._round:
            self._round = self.rng.permutation(self.n).tolist()
        return self._round.pop()


def touches(cold_pages: np.ndarray, n: int, seed: int, client: int, start: int) -> np.ndarray:
    """The guest's ``n`` cold-page touches of one cold start, in seeded order
    (as the smoke's pod phase draws them)."""
    rng = np.random.default_rng([int(seed) & MASK63, 29, int(client) & MASK63, int(start) & MASK63])
    return rng.permutation(cold_pages)[:n]
