"""Port parity: TouchEvent telemetry, the first-touch Markov model and the
PrefetchPolicy extent order against the JAX package for the same heat."""
import numpy as np
import pytest

from repro import core as ref
from repro_torch import core as port
from test_torch_snapshot import publish_both


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t


def _feed(mod, hm, walks):
    for stream, runs in enumerate(walks):
        for r in runs:
            hm.record(mod.TouchEvent(pages=np.arange(r * mod.RUN_PAGES, (r + 1) * mod.RUN_PAGES),
                                     kind="demand_fault", stream=stream, now=1.0))
        hm.end_stream(stream)


def _walks(seed, n_runs):
    rng = np.random.default_rng(seed)
    base = rng.permutation(n_runs)
    walks = [list(base)]
    for _ in range(3):
        w = list(base)
        i, j = rng.choice(n_runs, 2, replace=False)
        w[i], w[j] = w[j], w[i]
        walks.append(w)
    return walks


class _Session:
    def __init__(self, reader, heat):
        self.reader, self.heat = reader, heat


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_model_scores_and_run_order_match(seed):
    maps = []
    for mod in (ref, port):
        hm = mod.HeatMap(200, clock=FakeClock())
        _feed(mod, hm, _walks(seed, 25))
        maps.append(hm)
    hr, hg = maps
    for a, b in zip(hr.transition_counts(), hg.transition_counts()):
        np.testing.assert_array_equal(a, b)
    assert hr.stats == hg.stats
    mr, mg = ref.fit_prefetch_model(hr), port.fit_prefetch_model(hg)
    np.testing.assert_array_equal(mr.trans, mg.trans)
    np.testing.assert_array_equal(mr.start, mg.start)
    for seed_run in (None, 0, 3, 24):
        np.testing.assert_array_equal(mr.run_order(seed_run), mg.run_order(seed_run))
        # both evaluate the matvecs in float32; the scores come out bit-equal
        np.testing.assert_array_equal(mr.run_scores(seed_run), mg.run_scores(seed_run))
    pages = np.arange(0, 200, 3)
    np.testing.assert_array_equal(mr.page_order(pages), mg.page_order(pages))


@pytest.mark.parametrize("seed", [1, 2])
def test_policies_give_the_same_extent_order(seed):
    (_, pool_r, reg_r), (_, pool_g, reg_g), _ = publish_both(seed=seed)
    rd_r = ref.SnapshotReader(reg_r, pool_r.host_view("h"), pool_r.rdma)
    rd_g = port.SnapshotReader(reg_g, pool_g.host_view("h"), pool_g.rdma)
    heat = []
    for mod in (ref, port):
        hm = mod.HeatMap(reg_g.total_pages, clock=FakeClock())
        _feed(mod, hm, _walks(seed, reg_g.total_pages // mod.RUN_PAGES))
        heat.append(hm)
    s_r, s_g = _Session(rd_r, heat[0]), _Session(rd_g, heat[1])
    for pr, pg in ((ref.LayoutOrderPolicy(6), port.LayoutOrderPolicy(6)),
                   (ref.PredictedOrderPolicy(6), port.PredictedOrderPolicy(6))):
        for fault in (None, 40, 150):
            assert list(pr.order_extents(s_r, fault)) == list(pg.order_extents(s_g, fault))
    # no telemetry: predicted order falls back to layout order
    cold = _Session(rd_g, port.HeatMap(reg_g.total_pages, clock=FakeClock()))
    assert (list(port.PredictedOrderPolicy(6).order_extents(cold))
            == list(port.LayoutOrderPolicy(6).order_extents(cold)))


def test_heat_registry_and_decay_match():
    regs = []
    for mod in (ref, port):
        clock = FakeClock()
        reg = mod.HeatRegistry(clock=clock, half_life_s=2.0)
        for k, kind in enumerate(("demand_fault", "prefetch_hit", "touch")):
            clock.t = float(k)
            reg.record(mod.TouchEvent(pages=[1, 2, 2, 9], kind=kind, name="m",
                                      version=1, total_pages=16, stream=k))
        clock.t = 5.0
        regs.append(reg)
    hr, hg = (r.find("m", 1) for r in regs)
    np.testing.assert_array_equal(hr.counts(), hg.counts())
    assert hr.stats == hg.stats
    np.testing.assert_array_equal(hr.promotion_candidates(np.arange(16), 0.1),
                                  hg.promotion_candidates(np.arange(16), 0.1))
    with pytest.raises(ValueError):
        regs[1].record(port.TouchEvent(pages=[1]))
    assert isinstance(port.resolve_policy(None), port.LayoutOrderPolicy)
    chosen = port.PredictedOrderPolicy(9)
    assert port.resolve_policy(chosen) is chosen
