"""The port's device conditionals (nbody_tpu_torch.ops._graph) and the two
3D gates built on them, on the CPU: the dense collector's spill pass and
the runs evaluator's segment-packing gate, both the JAX package's
``lax.cond``.  The conditional nodes themselves exist only under a CUDA
graph's capture (tests/test_torch_cuda.py).

Bounds, each with its reason:

* integer fields (direct ranges, overflow flags, the escaped groups) and
  which branch a gate takes: exactly equal;
* each group's approx masses against the JAX dense collector: sorted,
  rtol 1e-5, the JAX package's own criterion for its dense collector
  (tests/test_collect_dense.py:75-87; tests/test_torch_dense3.py);
* the force pass through either packing branch against the JAX
  package's XLA route: 1e-5 of the largest |a| (tests/test_list_eval.py:131,
  as tests/test_torch_3d.py holds the whole pass).

The last test runs one step of each configuration that a fused run
used to send step by step or not (the 14 of the former ``host_gate``)
at a small N with its route forced, under a guard that makes every host
read of a tensor raise (the Python-level ones, and those torch makes in
C++: a 0-d or boolean tensor index, ``nonzero`` and its kin), except the
one read of a gate outside capture (``_graph._host_value``, inside
``device_if``) and the kernels' plain twins, which stand in on the CPU
for launches that read nothing on the card.  tests/test_torch_parallel_fused.py
holds the sharded steps to the same guard.
"""

import contextlib
import functools
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch
from nbody_tpu.ops import bh3d as jb
from nbody_tpu.ops import collect_dense3 as jd
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops import _graph
from nbody_tpu_torch.ops import allpairs as tap
from nbody_tpu_torch.ops import bh3d as tb
from nbody_tpu_torch.ops import bh_grouped as tbg
from nbody_tpu_torch.ops import collect_dense3 as td
from nbody_tpu_torch.ops import list_eval as tle

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dense3 import TINY_WINDOWS, _cloud, _jbox, _setup, _tbox  # noqa: E402

G = 6.67e-11
FORCE_TOL = 1e-5


# -- device_if / device_cond outside capture ------------------------------


@pytest.mark.parametrize("value,want", [(True, 1), (False, 0), (3, 3),
                                        (0, 0)],
                         ids=["true", "false", "int", "zero"])
def test_device_if_outside_capture(value, want):
    """``fn`` runs iff ``pred`` is nonzero; the host value is returned."""
    calls = []
    got = _graph.device_if(torch.tensor(value), lambda: calls.append(1))
    assert got == want
    assert calls == ([1] if want else [])


@pytest.mark.parametrize("value", [True, False])
def test_device_cond_outside_capture(value):
    calls = []
    got = _graph.device_cond(torch.tensor(value), lambda: calls.append("t"),
                             lambda: calls.append("f"))
    assert got is value
    assert calls == (["t"] if value else ["f"])


def test_tally_outside_capture_adds_now():
    before = td.ESCAPED_GROUPS, td.SPILL_PASSES
    _graph.tally(("collect_dense3", "ESCAPED_GROUPS"), torch.tensor(5))
    _graph.tally(("collect_dense3", "SPILL_PASSES"), 2)
    assert (td.ESCAPED_GROUPS, td.SPILL_PASSES) == (before[0] + 5,
                                                    before[1] + 2)
    _graph.add_counts({("collect_dense3", "ESCAPED_GROUPS"): -5,
                       ("collect_dense3", "SPILL_PASSES"): -2})


# -- the spill pass over a fixed spill_cap rows -----------------------------


def _group_sets(lm, ranges, gi):
    a = np.sort(lm[gi][lm[gi] > 0])
    r = ranges[gi][ranges[gi][:, 1] > 0]
    return a, r[np.lexsort(r.T)]


# (window schedule, spill_cap, escaped groups): none escape the default
# windows of the two-blob state; the tiny windows (tests/test_collect_dense.py:148)
# make all 16 groups escape, spilled whole or 2 of them
SPILLS = [("default", None, 0), ("tiny", None, 16), ("tiny", 2, 16)]


@pytest.mark.parametrize("sched,spill_cap,escaped", SPILLS,
                         ids=["none-escaped", "some", "beyond-spill_cap"])
def test_fixed_row_spill_matches_jax(sched, spill_cap, escaped):
    _, _, jtree, ttree, jspyr, tspyr, bbox, kw = _setup(8192, 0, True,
                                                        gs=512)
    g = bbox[0].shape[0]
    md = ttree.max_depth
    sched = None if sched == "default" else TINY_WINDOWS[:md + 1]
    kw = dict(kw, window_schedule=sched, spill_cap=spill_cap)
    before = td.ESCAPED_GROUPS, td.SPILL_PASSES, td.DENSE_PASSES
    (_, _, _, tlm), tr, tovf = td.collect_lists_3d_dense(
        _tbox(bbox), ttree, tspyr, **kw)
    assert td.ESCAPED_GROUPS - before[0] == escaped
    assert td.SPILL_PASSES - before[1] == int(escaped > 0)
    assert td.DENSE_PASSES - before[2] == 1
    (_, _, _, jlm), jr, jovf = jax.jit(lambda b: jd.collect_lists_3d_dense(
        b, jtree, jspyr, **kw))(_jbox(bbox))
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    cap = min(max(48, g // 4) if spill_cap is None else spill_cap, g)
    assert int(tovf.sum()) == max(escaped - cap, 0)
    jlm, jr, tlm, tr = np.asarray(jlm), np.asarray(jr), tlm.numpy(), tr.numpy()
    for gi in range(g):
        if tovf[gi]:
            continue
        ja, jrs = _group_sets(jlm, jr, gi)
        ta, trs = _group_sets(tlm, tr, gi)
        assert len(ja) == len(ta) > 0
        np.testing.assert_allclose(ta, ja, rtol=1e-5)
        np.testing.assert_array_equal(trs, jrs)


# -- the segment-packing gate -----------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_force(dcm):
    m, p = _cloud(4096, 3, False)
    want, ovf = jb.bh3_accelerations_grouped(
        jnp.asarray(p), jnp.asarray(m), g=G, group_size=512,
        direct_cell_max=dcm, use_pallas=False, return_diagnostics=True)
    assert int(np.asarray(ovf).sum()) == 0
    return m, p, np.asarray(want)


# direct_cell_max -> the mean merged run (lanes) of the uniform 4,096-body
# state at group 512: 107.5 at 32 (below SEG_PACK_MIN_RUN_LANES = 112:
# plain, K2), 253.0 at 64 (packed, K3)
@pytest.mark.parametrize("dcm,packed", [(32, False), (64, True)],
                         ids=["plain-K2", "packed-K3"])
def test_packing_branch_matches_jax(dcm, packed, monkeypatch):
    m, p, want = _jax_force(dcm)
    means, seen = [], []
    orig_eval, orig_runs = tbg._evaluate_runs, tle.list_eval_runs

    def eval_spy(*a, **kw):
        from nbody_tpu_torch.ops.experiments import merge_ranges

        c = merge_ranges(a[3], cap=kw["run_cap"])[0][:, :, 1]
        means.append(float(c.sum()) / max(int((c > 0).sum()), 1))
        return orig_eval(*a, **kw)

    def runs_spy(*a, seg_pack=1, **kw):
        seen.append(seg_pack)
        return orig_runs(*a, seg_pack=seg_pack, **kw)

    monkeypatch.setattr(tbg, "_evaluate_runs", eval_spy)
    monkeypatch.setattr(tle, "list_eval_runs", runs_spy)
    got, ovf = tb.bh3_accelerations_grouped(
        torch.tensor(p), torch.tensor(m), g=G, group_size=512, seg_pack=4,
        eval_k_tile=512, direct_cell_max=dcm, return_diagnostics=True)
    assert len(means) == 1
    assert (means[0] >= tbg.SEG_PACK_MIN_RUN_LANES) is packed
    assert seen == [4 if packed else 1]
    assert int(ovf.sum()) == 0 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want,
                               atol=FORCE_TOL * np.abs(want).max())


# -- no host read in the step -------------------------------------------------

# the kernels' wrappers, whose CPU twins stand in for launches
TWINS = ((tap, "allpairs_accelerations_vs"), (tle, "list_eval_runs"),
         (tle, "list_eval_runs_split"), (tle, "list_eval_pallas"),
         (tle, "list_eval_dynamic"))
READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "nonzero", "cpu", "numpy")
# torch functions that read the host inside C++: the count of their
# output's rows (torch.where of one argument is torch.nonzero)
SIZED = ("nonzero", "masked_select", "unique", "argwhere")


def _reads_in_index(index) -> bool:
    """Whether indexing with ``index`` reads the host inside torch: a 0-d
    integer or bool tensor (taken as a Python int or bool) or a boolean
    mask (its true count sizes the result)."""
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and (
        i.dtype == torch.bool or (i.dim() == 0 and not i.is_floating_point()))
        for i in parts)


@contextlib.contextmanager
def _no_host_reads():
    """Make the host reads of a tensor raise, except inside
    ``_graph._host_value`` and the kernels' wrappers: the Python-level
    reads (``READS``), and those torch makes in C++ (``SIZED``, a
    ``repeat_interleave`` without ``output_size``, ``torch.where`` of one
    argument, indexing by a 0-d tensor or a boolean mask).  Counted per
    thread, so that thread ranks are held each on its own; yields the
    reads that were allowed, by where."""
    local = threading.local()
    lock = threading.Lock()
    seen = {"gate": 0}

    def depth() -> int:
        return getattr(local, "depth", 0)

    def check(what: str) -> None:
        if not depth():
            raise AssertionError(f"host read: {what} in the step")

    def allow(fn, tag):
        def run(*a, **kw):
            local.depth = depth() + 1
            with lock:
                seen[tag] = seen.get(tag, 0) + 1
            try:
                return fn(*a, **kw)
            finally:
                local.depth -= 1
        return run

    def guard(name, orig):
        def read(self, *a, **kw):
            check(f"Tensor.{name}")
            return orig(self, *a, **kw)
        return read

    def sized(name, orig):
        def read(*a, **kw):
            check(f"torch.{name}")
            return orig(*a, **kw)
        return read

    def repeat(orig):
        def read(*a, **kw):
            # tensor repeats (or none: the input is the repeats) size the
            # result from their sum, unless output_size gives it
            reps = a[1] if len(a) > 1 else kw.get("repeats")
            if kw.get("output_size") is None and (
                    reps is None or isinstance(reps, torch.Tensor)):
                check("repeat_interleave without output_size")
            return orig(*a, **kw)
        return read

    def where(orig):
        def read(*a, **kw):
            if len(a) + len(kw) == 1:
                check("torch.where of one argument")
            return orig(*a, **kw)
        return read

    def index(name, orig):
        def read(self, idx, *a):
            if _reads_in_index(idx):
                check(f"Tensor.{name} with a 0-d or boolean tensor index")
            return orig(self, idx, *a)
        return read

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_graph, "_host_value", allow(_graph._host_value, "gate"))
        for mod, name in TWINS:
            mp.setattr(mod, name, allow(getattr(mod, name), name))
        for name in READS:
            mp.setattr(torch.Tensor, name,
                       guard(name, getattr(torch.Tensor, name)))
        for name in SIZED:
            mp.setattr(torch, name, sized(name, getattr(torch, name)))
        for owner in (torch, torch.Tensor):
            mp.setattr(owner, "repeat_interleave",
                       repeat(owner.repeat_interleave))
        for name in ("unique", "masked_select", "argwhere"):
            mp.setattr(torch.Tensor, name,
                       guard(name, getattr(torch.Tensor, name)))
        mp.setattr(torch, "where", where(torch.where))
        for name in ("__getitem__", "__setitem__"):
            mp.setattr(torch.Tensor, name,
                       index(name, getattr(torch.Tensor, name)))
        yield seen


def _tiny_windows(max_depth):
    return TINY_WINDOWS[:max_depth + 1]


# the 14 configurations the fused run's route was decided for (9 that a
# graph held, 5 whose gates it could not), each at a small N with its
# route forced; "seg_pack" forces the packing gate's request, "escape"
# the tiny windows (every group escapes: the spill pass runs)
STEPS = [
    dict(n_bodies=2048, engine="barnes_hut"),
    dict(n_bodies=2048, engine="barnes_hut", eval_mode="dynamic"),
    dict(n_bodies=2048, engine="barnes_hut", compensated=True),
    dict(n_bodies=4096, engine="barnes_hut", split_eval=True),
    dict(n_bodies=512, engine="barnes_hut", bh_mode="exact"),
    dict(n_bodies=1024, engine="allpairs", n_dim=3),
    dict(n_bodies=2048, engine="barnes_hut", n_dim=3),
    dict(n_bodies=2048, engine="barnes_hut", n_dim=3, eval_mode="grid"),
    dict(n_bodies=4096, engine="barnes_hut", n_dim=3, collect3="gather",
         split_eval=True),
    dict(n_bodies=4096, engine="barnes_hut", n_dim=3, group_size=512,
         direct_cell_max=64, seg_pack=4),
    dict(n_bodies=4096, engine="barnes_hut", n_dim=3, group_size=512,
         direct_cell_max=32, collect3="gather", seg_pack=4),
    dict(n_bodies=8192, engine="barnes_hut", n_dim=3, collect3="dense"),
    dict(n_bodies=8192, engine="barnes_hut", n_dim=3, collect3="dense",
         split_eval=True),
    dict(n_bodies=8192, engine="barnes_hut", n_dim=3, collect3="dense",
         group_size=512, init_mode="blobs", escape=True),
]


@pytest.mark.parametrize("kw", STEPS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_step_reads_host_only_in_device_if(kw, monkeypatch):
    kw = dict(kw)
    seg_pack, escape = kw.pop("seg_pack", None), kw.pop("escape", False)
    if seg_pack:
        orig = tb.resolve_route_3d
        monkeypatch.setattr(tb, "resolve_route_3d", lambda *a, **k: orig(
            *a, **dict(k, seg_pack=seg_pack, eval_k_tile=512)))
    if escape:
        monkeypatch.setattr(td, "window_schedule_3d", _tiny_windows)
    sim = Simulation(nbody_tpu_torch.SimConfig(seed=4, **kw), device="cpu")
    state = sim.state
    spills = td.SPILL_PASSES
    with _no_host_reads() as seen:
        new = sim.step_fn(state)
    assert new.positions.shape == state.positions.shape
    assert torch.isfinite(new.positions).all()
    gated = seg_pack or kw.get("collect3") == "dense"
    assert seen["gate"] == (1 if gated else 0)
    if escape:
        assert td.SPILL_PASSES == spills + 1
