"""The compiler's device kernels on the CPU: the eps-band dominance kernel
(rows A2 and A3, ``csrc/pareto_dominated.cu``) and the lattice roll-up
(row A1, ``csrc/lattice_rollup.cu``).

The kernels run only on a CUDA card (``tests/test_torch_cuda.py`` holds
them against their plain versions there).  Here:

* the plain versions against the JAX package's functions on the same
  numpy inputs: ``dominated_ref`` (every row, or block-local as the
  sharded mask's phase 1) against ``repro.core.pareto.chunk_dominated``,
  and the sharded mask on CPU meshes against the reference's host mask;
* the routing: every call site (``batched.pareto_mask``,
  ``pareto.nondominated_mask_sharded``, ``engine._dispatch`` under each
  engine strategy) runs the plain version for CPU tensors and the
  kernel's binding for any other device, shown on the ``meta`` device
  with the binding patched, and a binding's failure propagates instead of
  falling back;
* ``kernels/build.py`` builds ``lattice_rollup.cu`` with ``-fmad=false``;
* the dominance kernel's two passes as far as the CPU can see them: which
  passes a call launches (``passes``), the source's constants against the
  binding's and the edge sets', and the edge sets' witnesses on the
  boundaries the passes split the rows at, the wide passes' chunks
  included; the wide kernels' objective counts (more than
  ``MAX_OBJECTIVES``, and none) past the binding's objective check;
* the CPU route of ``batched.pareto_mask`` (two passes of the plain
  version) against the plain version over all pairs on every edge set.

All comparisons are exact (booleans, float64 bits).
"""

import subprocess

import numpy as np
import pytest
import torch

from repro.core import pareto as R_pareto

import repro_torch.core as C
from repro_torch.core import batched as B
from repro_torch.core import engine as E
from repro_torch.core import pareto as P
from repro_torch.kernels import build
from repro_torch.kernels.lattice_rollup import kernel as rollup_kernel
from repro_torch.kernels.pareto_dominated import kernel as dom_kernel
from repro_torch.parallel import host_spec_mesh, spec_sweep_mesh
from torch_dominance_cases import (WIDE_CHUNK, WIDE_ROWS, boundary_rows,
                                   chunk_rows, dominance_cases)

EPS = P.PARETO_EPS
CASES = dominance_cases(EPS, seed=0)
META = torch.device("meta")


def _t(a, device="cpu"):
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def _reference_verdicts(case) -> np.ndarray:
    """The JAX package's predicate (numpy), block by block for seg > 0."""
    if not case.seg:
        return R_pareto.chunk_dominated(case.rows, case.cands, EPS)
    return np.concatenate([
        R_pareto.chunk_dominated(case.rows[s:s + case.seg],
                                 case.cands[s:s + case.seg], EPS)
        for s in range(0, len(case.cands), case.seg)])


# ---------------------------------------------------------------------------
# The plain versions against the reference
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread for tests that run many small torch ops: under
    several test workers, each worker's thread pool would contend for the
    cores and each op wait on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_dominated_ref_equals_reference(case, one_thread):
    got = P.dominated(_t(case.rows), _t(case.cands), EPS, seg=case.seg)
    assert got.dtype == torch.bool and got.shape == (len(case.cands),)
    np.testing.assert_array_equal(got.numpy(), _reference_verdicts(case))


@pytest.mark.parametrize("chunk", [1, 64, 300, 4096])
def test_dominated_ref_verdicts_do_not_depend_on_the_chunk(chunk):
    case = next(c for c in CASES if c.name == "near_ties_front")
    np.testing.assert_array_equal(
        P.dominated_ref(_t(case.rows), _t(case.cands), EPS, chunk=chunk)
        .numpy(), _reference_verdicts(case))


@pytest.mark.parametrize("seg", [64, 100, 1024])
def test_seg_plain_version_equals_phase1_blocks(seg):
    """Block-local verdicts equal A3's phase 1 as it was written: one
    ``chunk_dominated(blk, blk)`` per block of a padded shard."""
    rng = np.random.default_rng(seg)
    objs = np.concatenate([rng.random((3 * seg + 17, 3)),
                           np.full((seg - 17, 3), np.inf)])
    shard = _t(objs)
    want = torch.cat([P.chunk_dominated(shard[s:s + seg],
                                        shard[s:s + seg], EPS)
                      for s in range(0, len(objs), seg)])
    got = P.dominated(shard, shard, EPS, seg=seg)
    assert torch.equal(got, want)


def test_seg_needs_one_count_of_rows_and_candidates():
    with pytest.raises(ValueError, match="as many rows as candidates"):
        P.dominated(_t(np.zeros((5, 3))), _t(np.zeros((4, 3))), EPS, seg=2)


@pytest.mark.parametrize("chunk", [64, 512])
@pytest.mark.parametrize("case", [c for c in CASES if not c.seg],
                         ids=[c.name for c in CASES if not c.seg])
def test_cpu_pareto_mask_equals_all_pairs(case, chunk, one_thread):
    """The CPU route's block prefilter then survivors against every row
    gives the all-pairs verdicts of the plain version."""
    rows = _t(case.rows)
    want = ~P.dominated_ref(rows, rows, EPS).numpy()
    np.testing.assert_array_equal(
        B.pareto_mask(case.rows, chunk=chunk, device="cpu"), want)


def test_empty_candidates():
    got = P.dominated(_t(np.zeros((5, 3))), _t(np.zeros((0, 3))), EPS)
    assert got.shape == (0,) and got.dtype == torch.bool


@pytest.mark.parametrize("n_dev", [1, 3, 4])
@pytest.mark.parametrize("chunk", [None, 64, 500])
def test_sharded_mask_equals_reference_host_mask(n_dev, chunk):
    case = next(c for c in CASES if c.name == "near_ties_front")
    got = P.nondominated_mask_sharded(case.rows, chunk=chunk,
                                      mesh=spec_sweep_mesh(["cpu"] * n_dev))
    np.testing.assert_array_equal(got, R_pareto.nondominated_mask(case.rows))


@pytest.mark.parametrize("name", ["inf_pad_rows", "nan_entries",
                                  "signed_zeros", "duplicates"])
def test_device_masks_equal_reference_on_edge_sets(name):
    case = next(c for c in CASES if c.name == name)
    want = ~_reference_verdicts(case)
    np.testing.assert_array_equal(B.pareto_mask(case.rows, device="cpu"),
                                  want)
    np.testing.assert_array_equal(
        P.nondominated_mask_sharded(case.rows,
                                    mesh=spec_sweep_mesh(["cpu"] * 3)),
        R_pareto.nondominated_mask(case.rows))


# ---------------------------------------------------------------------------
# Routing: CPU tensors take the plain version, others the binding
# ---------------------------------------------------------------------------


class _Recorder:
    """A stand-in binding: records each call and answers with CPU tensors
    (a ``meta`` tensor has no data to copy back)."""

    def __init__(self, answer=None, error=None):
        self.calls, self.answer, self.error = [], answer, error

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        if self.error is not None:
            raise self.error
        return self.answer(*args, **kwargs)


def _no_dominance(rows, cands, eps, seg=0):
    assert rows.device == META and cands.device == META
    return torch.zeros(cands.shape[0], dtype=torch.bool)


@pytest.fixture
def dom_binding(monkeypatch):
    rec = _Recorder(answer=_no_dominance)
    monkeypatch.setattr(dom_kernel, "pareto_dominated_cuda", rec)
    return rec


@pytest.fixture
def refuse_bindings(monkeypatch):
    """Bindings that fail the test if a CPU call reaches them."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel's binding")
    monkeypatch.setattr(dom_kernel, "pareto_dominated_cuda", refuse)
    monkeypatch.setattr(rollup_kernel, "lattice_rollup_cuda", refuse)


def test_dominated_routes_by_device(dom_binding, refuse_bindings,
                                    monkeypatch):
    objs = np.random.default_rng(0).random((50, 3))
    P.dominated(_t(objs), _t(objs), EPS)              # CPU: plain
    monkeypatch.setattr(dom_kernel, "pareto_dominated_cuda", dom_binding)
    got = P.dominated(_t(objs, META), _t(objs, META), EPS, seg=8, chunk=3)
    assert got.shape == (50,)
    ((args, kwargs),) = dom_binding.calls
    assert args[2:] == (EPS, 8) and not kwargs


def test_pareto_mask_one_launch_per_frontier(dom_binding):
    objs = np.random.default_rng(1).random((700, 3))
    mask = B.pareto_mask(objs, chunk=64, device="meta")
    assert mask.all() and mask.shape == (700,)
    ((args, _),) = dom_binding.calls
    assert args[0].shape == (700, 3) and args[1].shape == (700, 3)
    assert args[3] == 0


def test_frontier_indices_route_through_the_binding(dom_binding):
    tech = C.calibrated_tech_for_reference()
    sweep = C.design_space_sweep(C.scenario_specs()["language"], tech,
                                 device="cpu")
    sweep.device = META
    sweep.frontier_indices()
    assert len(dom_binding.calls) == 1


@pytest.mark.parametrize("n_dev", [1, 3])
def test_sharded_mask_two_launches_per_entry(dom_binding, n_dev):
    objs = np.random.default_rng(2).random((1000, 3))
    mesh = spec_sweep_mesh(["meta"] * n_dev)
    mask = P.nondominated_mask_sharded(objs, chunk=128, mesh=mesh)
    assert mask.all()
    segs = [args[3] for args, _ in dom_binding.calls]
    assert segs == [128] * n_dev + [0] * n_dev
    per = -(-1000 // n_dev)
    for args, _ in dom_binding.calls[n_dev:]:
        assert args[0].shape == (1000, 3) and args[1].shape == (per, 3)


def test_cpu_call_sites_never_reach_the_bindings(refuse_bindings):
    objs = np.random.default_rng(3).random((300, 3))
    want = R_pareto.nondominated_mask(objs)
    np.testing.assert_array_equal(B.pareto_mask(objs, device="cpu"), want)
    np.testing.assert_array_equal(
        P.nondominated_mask_sharded(objs, mesh=spec_sweep_mesh(["cpu"] * 2)),
        want)
    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())[:2]
    for mode in ("jit", "vmap"):
        for s in specs[:1 if mode == "jit" else 2]:
            E.execute(E.plan([s], tech, mode=mode, device="cpu"))
    for mode, mesh in (("sharded-jit", spec_sweep_mesh(["cpu"] * 2)),
                       ("pmap", spec_sweep_mesh(["cpu"] * 2)),
                       ("multihost", host_spec_mesh(["cpu"] * 2))):
        E.execute(E.plan(specs, tech, mode=mode, mesh=mesh))


@pytest.mark.parametrize("where", ["pareto_mask", "sharded"])
def test_dominance_binding_failure_propagates(monkeypatch, where):
    err = RuntimeError("pareto_dominated launch failed: CUDA error 1")
    monkeypatch.setattr(dom_kernel, "pareto_dominated_cuda",
                        _Recorder(error=err))
    objs = np.random.default_rng(4).random((100, 3))
    with pytest.raises(RuntimeError, match="launch failed"):
        if where == "pareto_mask":
            B.pareto_mask(objs, device="meta")
        else:
            P.nondominated_mask_sharded(objs,
                                        mesh=spec_sweep_mesh(["meta"] * 2))


def test_unpatched_binding_refuses_a_device_other_than_cuda():
    objs = _t(np.zeros((4, 3)), META)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        P.dominated(objs, objs, EPS)


# ---------------------------------------------------------------------------
# The dominance kernel's two passes
# ---------------------------------------------------------------------------

R = dom_kernel.SCREEN_ROWS


@pytest.mark.parametrize("n,c,seg,want", [
    (0, 5, 0, ("screen",)),
    (5, 0, 0, ()),
    (R, 9, 0, ("screen",)),
    (R + 1, 9, 0, ("screen", "split")),
    (138_348, 138_348, 0, ("screen", "split")),
    (5000, 5000, R, ("screen",)),
    (5000, 5000, R + 1, ("screen", "split")),
    (R, R, 4 * R, ("screen",)),
    (R + 1, R + 1, 4 * R, ("screen", "split")),
])
def test_passes_a_call_launches(n, c, seg, want):
    assert dom_kernel.passes(n, c, seg) == want


WIDE = ("wide_screen", "wide_split")


@pytest.mark.parametrize("n,c,seg,k,want", [
    (100, 100, 0, 0, WIDE[:1]),
    (100, 100, 0, 9, WIDE[:1]),
    (R, 9, 0, 12, WIDE[:1]),
    (R + 1, 9, 0, 9, WIDE),
    (R + 1, R + 1, 0, 0, WIDE[:1]),
    (138_348, 138_348, 0, 12, WIDE),
    (5000, 5000, dom_kernel.screen_rows(64), 64, WIDE[:1]),
    (5000, 5000, dom_kernel.screen_rows(64) + 1, 64, WIDE),
    (5000, 5000, R, 64, WIDE),
    (5000, 5000, R + 1, 80, WIDE),
    (5000, 5000, R + 1, 0, WIDE[:1]),
    (5, 0, 0, 12, ()),
    (5, 0, 0, 0, ()),
    (R + 1, 9, 0, dom_kernel.MAX_OBJECTIVES, ("screen", "split")),
])
def test_passes_of_the_wide_route(n, c, seg, k, want):
    assert dom_kernel.passes(n, c, seg, k) == want


def test_source_constants_equal_the_binding_and_the_edge_sets():
    import re
    text = (build.CSRC / "pareto_dominated.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(const["kScreenRows"]) == dom_kernel.SCREEN_ROWS
    assert int(const["kMaxObjectives"]) == dom_kernel.MAX_OBJECTIVES
    assert int(const["kWideStage"]) == dom_kernel.WIDE_STAGE
    few, many = re.search(r"chunk_rows\(\) \{\s*return K <= 4 \? (\d+) "
                          r": (\d+);\s*\}", text).groups()
    for k in range(1, dom_kernel.MAX_OBJECTIVES + 1):
        assert chunk_rows(k) == int(few if k <= 4 else many)
    # the wide kernels' chunks and the wide screen's stream
    assert int(const["kWideChunk"]) == WIDE_CHUNK
    assert int(const["kWideRows"]) == WIDE_ROWS
    assert int(const["kWideScreenValues"]) == dom_kernel.WIDE_SCREEN_VALUES
    assert int(const["kWideScreenWarps"]) == dom_kernel.WIDE_SCREEN_WARPS
    assert int(const["kWideGroup"]) == dom_kernel.WIDE_GROUP
    assert re.search(r"wide_screen_rows\(int64_t k\) \{\s*if \(k > "
                     r"kWideStage\) return kScreenRows;\s*const int64_t rows ="
                     r"\s*\(kWideScreenValues / k - 1 - 2 \* kWideGroup \* "
                     r"kWideScreenWarps\) / 32 \*\s*32;\s*return static_cast"
                     r"<int>\(rows < kScreenRows \? rows : kScreenRows\);",
                     text)
    assert [dom_kernel.screen_rows(k) for k in (8, 9, 24, 28, 64, 65)] == \
        [R, R, R, 928, 352, R]
    assert re.search(r"wide_chunk_rows\(int64_t k\) \{\s*return k <= "
                     r"kWideStage \? static_cast<int>\(kWideChunk / k\) / 32 "
                     r"\* 32\s*: kWideRows;\s*\}", text)
    for k in range(dom_kernel.MAX_OBJECTIVES + 1, 200):
        want = (WIDE_CHUNK // k // 32 * 32 if k <= dom_kernel.WIDE_STAGE
                else WIDE_ROWS)
        assert chunk_rows(k) == want and want % 32 == 0 and want >= 32


def test_edge_sets_reach_both_passes():
    split = [c.name for c in CASES
             if "split" in dom_kernel.passes(len(c.rows), len(c.cands),
                                             c.seg, c.rows.shape[1])]
    for name in ("lone_front", "witness_last_row", "plane_5k",
                 "antichain_10k", "seg_1500_budget", "inf_pad_survivors",
                 "nan_survivors", "boundary_witnesses_k2",
                 "seg_boundary_witnesses"):
        assert name in split
    for name in ("n1_c1_same", "seg_512_budget", "seg_1024_budget"):
        assert name not in split


def test_wide_edge_sets_take_the_wide_kernel():
    wide = [c.name for c in CASES
            if dom_kernel.passes(len(c.rows), len(c.cands), c.seg,
                                 c.rows.shape[1])[0] == "wide_screen"]
    assert wide == ["random_k9", "random_k12", "random_k16", "random_k64",
                    "near_ties_k12", "boundary_witnesses_k12",
                    "seg_300_k12", "k0", "boundary_witnesses_k9",
                    f"boundary_witnesses_k{dom_kernel.WIDE_STAGE}",
                    "boundary_witnesses_k80", "seg_boundary_witnesses_k12",
                    "seg_boundary_witnesses_k80", "simplex_k80"]


def test_wide_edge_sets_reach_both_wide_passes():
    split = [c.name for c in CASES
             if "wide_split" in dom_kernel.passes(
                 len(c.rows), len(c.cands), c.seg, c.rows.shape[1])]
    assert split == ["random_k64", "near_ties_k12", "boundary_witnesses_k12",
                     "boundary_witnesses_k9",
                     f"boundary_witnesses_k{dom_kernel.WIDE_STAGE}",
                     "boundary_witnesses_k80", "seg_boundary_witnesses_k12",
                     "seg_boundary_witnesses_k80", "simplex_k80"]
    # past the staging limit, and the sets whose tests are longer than the
    # screen's rows
    assert max(c.rows.shape[1] for c in CASES) > dom_kernel.WIDE_STAGE
    assert all(c.seg > R for c in CASES
               if c.name.startswith("seg_boundary_witnesses_k"))


@pytest.mark.parametrize("name", [
    "boundary_witnesses_k2", "boundary_witnesses_k3",
    f"boundary_witnesses_k{dom_kernel.MAX_OBJECTIVES}",
    "boundary_witnesses_k12", "boundary_witnesses_k9",
    f"boundary_witnesses_k{dom_kernel.WIDE_STAGE}", "boundary_witnesses_k80"])
def test_boundary_witnesses_sit_on_the_boundaries(name):
    case = next(c for c in CASES if c.name == name)
    n, k = case.rows.shape
    at, budget, ch = boundary_rows(n, k), dom_kernel.screen_rows(k), \
        chunk_rows(k)
    # the sampled rows, the budget, chunk starts and ends, the last row
    assert {0, budget - 1, budget, ch - 1, ch, n - 1} <= set(at)
    assert (budget - 1) * (n // budget) in at
    if k > dom_kernel.MAX_OBJECTIVES:
        # every chunk start and end of the wide split (its partitions are
        # whole chunks)
        assert {r for m in range(ch, n, ch) for r in (m - 1, m)} <= set(at)
    dom = np.stack([R_pareto.chunk_dominated(case.rows[r:r + 1], case.cands,
                                             EPS) for r in range(n)])
    assert [list(np.flatnonzero(dom[:, j])) for j in range(len(at))] == \
        [[r] for r in at]


def test_seg_boundary_witnesses_sit_on_either_side_of_the_budget():
    case = next(c for c in CASES if c.name == "seg_boundary_witnesses")
    seg = case.seg
    at = boundary_rows(seg, 3, seg)
    assert seg > R and {R - 1, R, seg - 1} <= set(at)
    for j, w in enumerate(at):
        blk = case.rows[j * seg:(j + 1) * seg]
        dom = R_pareto.chunk_dominated(blk[w:w + 1], blk, EPS)
        assert dom[5] and R_pareto.chunk_dominated(
            np.delete(blk, w, axis=0), blk[5:6], EPS).tolist() == [False]


@pytest.mark.parametrize("name", ["seg_boundary_witnesses_k12",
                                  "seg_boundary_witnesses_k80"])
def test_wide_seg_boundary_witnesses_sit_on_every_chunk_boundary(name):
    """Each block of a wide ``seg`` set longer than the screen's budget
    holds its candidates on its first rows off the boundaries and their
    only witnesses on the budget, every chunk start and end of the wide
    passes and the block's last row."""
    case = next(c for c in CASES if c.name == name)
    seg, k = case.seg, case.rows.shape[1]
    at = boundary_rows(seg, k, seg)
    ch, budget = chunk_rows(k), dom_kernel.screen_rows(k)
    assert seg > budget and {budget - 1, budget, seg - 1} <= set(at)
    assert {r for m in range(ch, seg, ch) for r in (m - 1, m)} <= set(at)
    cand_rows = [r for r in range(seg) if r not in set(at)][:len(at)]
    for s in range(0, len(case.rows), seg):
        blk = case.rows[s:s + seg]
        dom = np.stack([R_pareto.chunk_dominated(blk[r:r + 1],
                                                 blk[cand_rows], EPS)
                        for r in range(seg)])
        assert [list(np.flatnonzero(dom[:, j])) for j in range(len(at))] \
            == [[r] for r in at]


@pytest.mark.parametrize("k", [0, 9, 12])
def test_too_many_objectives_raise_on_the_kernel_route(k):
    """More objectives than the screen takes, and none, are the wide
    kernel's: they pass the binding's objective check and raise only at
    its device check, for not being on a card."""
    objs = np.random.default_rng(k).random((20, k))
    with pytest.raises(ValueError, match="CUDA tensor"):
        P.dominated(_t(objs, META), _t(objs, META), EPS)
    # the plain version takes any k on the CPU
    np.testing.assert_array_equal(
        P.dominated(_t(objs), _t(objs), EPS).numpy(),
        R_pareto.chunk_dominated(objs, objs, EPS))


# -- A1 ----------------------------------------------------------------------


def _packed(n_specs=2):
    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())[:n_specs]
    plan = E.plan(specs, tech, device="cpu")
    (group,) = plan.groups
    return E.pack_group([plan.lattices[i] for i in group],
                        [plan.tables[i] for i in group])


def test_eval_lattice_on_the_cpu_is_the_plain_version(refuse_bindings):
    packed = _packed()
    idx = E._gather_index(packed, torch.device("cpu"))
    got = E._dispatch(idx, packed.operands, torch.device("cpu"))
    tabs, consts, e_ofu, e_align = packed.operands
    want = B._eval_kernel(idx, tuple(_t(t) for t in tabs), _t(consts),
                          _t(e_ofu), _t(e_align))
    assert list(got) == list(want)
    assert list(got["breakdown"]) == list(want["breakdown"])
    for k in ("mac_base", "ofu_base", "area", "e_cycle"):
        assert torch.equal(got[k].view(torch.int64),
                           want[k].view(torch.int64))


class _Sentinel(Exception):
    pass


@pytest.mark.parametrize("mode", ["jit", "vmap", "sharded-jit", "pmap",
                                  "multihost"])
def test_every_strategy_routes_a_card_to_the_rollup_binding(monkeypatch,
                                                            mode):
    rec = _Recorder(error=_Sentinel())
    monkeypatch.setattr(rollup_kernel, "lattice_rollup_cuda", rec)
    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())[:1 if mode == "jit" else 3]
    mesh = None
    if mode in ("sharded-jit", "pmap"):
        mesh = spec_sweep_mesh(["meta"] * 2)
    elif mode == "multihost":
        mesh = host_spec_mesh(["meta"] * 2)
    plan = E.plan(specs, tech, mode=mode, mesh=mesh,
                  device=None if mesh else "meta")
    with pytest.raises(_Sentinel):
        E.execute(plan)
    ((args, _),) = rec.calls
    idx, tabs, consts, e_ofu, e_align = args
    assert all(t.device == META for t in (*idx, *tabs, consts, e_ofu,
                                          e_align))
    assert all(t.dtype == torch.int64 for t in idx)
    assert len(tabs) == len(rollup_kernel.TABLES)
    lanes = 1 if mode == "jit" else (3 if mode == "vmap" else 2)
    assert consts.shape == (lanes, 8)


def test_rollup_binding_refuses_a_device_other_than_cuda():
    packed = _packed(1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        E._dispatch(E._gather_index(packed, META), packed.operands, META)


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    cmds = []

    def run(cmd, capture_output, text):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    return cmds


def test_lattice_rollup_builds_without_fma_contraction(fake_nvcc):
    lib = build.build_library("lattice_rollup")
    (cmd,) = fake_nvcc
    assert "-fmad=false" in cmd and cmd[-1].endswith("lattice_rollup.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert lib == build.library_path("lattice_rollup") and lib.exists()
    build.build_library("lattice_rollup")            # built: no nvcc
    assert len(fake_nvcc) == 1


def test_other_sources_keep_the_default_flags(fake_nvcc):
    build.build_library("pareto_dominated")
    build.build_library("ssm_scan")
    assert all("-fmad=false" not in cmd for cmd in fake_nvcc)
    assert [cmd[-1].rsplit("/", 1)[1] for cmd in fake_nvcc] == \
        ["pareto_dominated.cu", "ssm_scan.cu"]


def test_source_flags_are_part_of_the_library_hash(monkeypatch):
    before = build.library_path("lattice_rollup")
    monkeypatch.setattr(build, "SOURCE_FLAGS", {})
    assert build.library_path("lattice_rollup") != before
    assert build.library_path("ssm_scan").name.startswith("libssm_scan-")
