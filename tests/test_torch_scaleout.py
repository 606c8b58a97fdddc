"""Scale-out of the port over meshes of CPU ranks (``torch.distributed``,
gloo, ``torch.multiprocessing`` from a script in ``tmp_path`` with
``file://`` init), against the JAX package's multi-device drills
(``tests/test_distributed.py``) and against the port's one-device path.

The reference side runs once in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and
``JAX_PLATFORMS=cpu``, as ``tests/test_distributed.py`` runs it: the
sharded train step on a (2, 4) ``('data', 'model')`` mesh, the int8
compressed all-reduce under ``shard_map`` over the ``pod`` axis of a (2, 4)
``('pod', 'data')`` mesh, and a checkpoint saved from a (4, 2) mesh.

* **Sharded train step** (the reference's ``test_sharded_train_step_8dev``
  scenario): smoke llama3.2-3b on a (2, 4) mesh of 8 ranks, batch 8 x 32,
  ``constant_lr(3e-3)``, 8 steps, from the reference's initial parameters
  (``convert.model_params_from_numpy``).  The 8 losses equal the
  reference's within ``LOSS_TOL`` relative and the port's one-device run's
  too; every rank holds a distinct piece of ``wq`` (the reference's
  ``n_shards == 8``).
* **Sharded against one device**, every smoke config on a (2, 2) mesh of 4
  ranks, batch 4 x 128 (a data rank holds 256 tokens, so granite's MoE
  groups stay within a rank): after step 0, each first moment ``m``
  (``(1 - b1)`` times the clipped gradient), gathered, within
  ``GRAD_TOL`` of its leaf's largest magnitude, ``grad_norm`` and ``aux``
  within ``NORM_TOL`` relative.  These hold where every int8 code agrees:
  the last-axis rows of each rank's fake-quant codes (one token's codes,
  or a weight's, gathered whole) must all be rows the one-device step
  quantized.  A MoE train batch whose 256-token groups span the data
  ranks (granite-moe-1b-a400m at 4 x 64, 128 tokens per data rank) equals
  one device's step under the same rules; served over them (no
  gradients), granite's logits equal one device's within ``GRAD_TOL`` of
  the largest.
* **Compression**: ``compressed_all_reduce_tree`` over the 2-rank pod
  groups of 8 ranks equals the reference's ``shard_map`` result bit for
  bit, mean and new error, on the same N(0, 0.01) gradients from
  ``default_rng(0)``.
* **Elastic**: the reference's ``test_elastic_remesh_roundtrip`` (save
  from a (4, 2) mesh, restore onto (2, 2) and (2, 1), bit identical), and
  the port reads the checkpoint the reference's 8-device scenario wrote.
* **Launchers** under ``torch.distributed.run``: ``launch.train`` on a
  2x2 mesh of 4 ranks prints the 1x1 run's losses, and a run saved on 2x2
  resumes on 1x1 with the uninterrupted run's next loss and on a 2x1 mesh
  of 2 ranks within the sharded tolerance; ``launch.serve`` on a 2x1 mesh
  of 2 ranks prints the 1x1 run's greedy tokens, for qwen3-4b and for
  granite-moe-3b-a800m, whose MoE token groups span the two batch ranks.
* ``constrain_act`` redistributes a DTensor to the placements the rules
  name.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import list_archs, smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.models import get_model
from repro_torch.optim import adamw_init, constant_lr
from repro_torch.train import init_train_state, make_train_step

REPO = Path(__file__).resolve().parent.parent
ARCHS = list_archs()
LOSS_TOL = 1e-4          # relative, the sharded step's losses
GRAD_TOL = 1e-5          # of each leaf's largest magnitude
NORM_TOL = 1e-6          # relative, grad_norm and aux
FLIP_LOSS = 1e-3         # relative, a loss from a step with a code flip on
B8, S8, STEPS8 = 8, 32, 8
B4, S4 = 4, 128
MOE_SERVE = "granite-moe-3b-a800m"     # served over 2 batch ranks
# trained on (2, 2) at 4 x 64: 128 tokens per data rank, so every 256-token
# MoE group spans both data ranks
MOE_SPAN, SPAN = "granite-moe-1b-a400m", (4, 64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one CPU thread in this module's process (restored after
    it), as its ranks and subprocesses run: the tensors are tiny, and with
    the suite's parallel workers sharing the cores, multi-threaded kernels
    on them spin far longer than they compute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO / "src"),
            "OMP_NUM_THREADS": "1", **extra}


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# the reference's 8-device scenarios, once
# ---------------------------------------------------------------------------

REF_SCRIPT = r'''
import hashlib, json, sys
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
import repro.quant.quantizers as JQ
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.ckpt import CheckpointManager, reshard_tree
from repro.configs import smoke_config
from repro.data import DataConfig, SyntheticCorpus
from repro.models import get_model
from repro.optim.adamw import adamw_init
from repro.optim.compression import compressed_psum_tree, ef_state_init
from repro.optim.schedules import constant_lr
from repro.parallel.logical import split_logical
from repro.parallel.sharding import rules_for_mesh
from repro.train.step import make_train_step

work = Path(sys.argv[1])
mk = ({'axis_types': (jax.sharding.AxisType.Auto,) * 2}
      if hasattr(jax.sharding, 'AxisType') else {})

def flat(t, pre=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from flat(v, pre + k + ".")
        else:
            yield pre + k, v

# every fake-quant's code rows, per step (the callback sees the whole array)
rows = [set() for _ in range(STEPS)]
cur = [0]
orig = JQ.quantize_int

def put(v):
    v = np.asarray(v)
    rows[cur[0]].update(hashlib.blake2b(x.tobytes(), digest_size=8)
                        .hexdigest() for x in v.reshape(-1, v.shape[-1]))

def rec(*a, **k):
    q, s = orig(*a, **k)
    jax.debug.callback(put, q)
    return q, s

JQ.quantize_int = rec

# the sharded train step (test_sharded_train_step_8dev)
cfg = smoke_config('llama3.2-3b')
api = get_model(cfg)
mesh = jax.make_mesh((2, 4), ('data', 'model'), **mk)
rules = rules_for_mesh(mesh)
params, specs = split_logical(api.init_params(jax.random.PRNGKey(0)), rules)
np.savez(work / "ref_params.npz",
         **{k: np.asarray(v) for k, v in flat(params)})
params = jax.device_put(params, jax.tree.map(
    lambda sp: NamedSharding(mesh, sp), specs))
opt = adamw_init(params)
corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH))
step = jax.jit(make_train_step(api, constant_lr(3e-3)),
               donate_argnums=(0, 1))
losses = []
with mesh:
    for i in range(STEPS):
        cur[0] = i
        b = {k: jnp.asarray(v) for k, v in corpus.batch(i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m['loss']))
        jax.effects_barrier()
JQ.quantize_int = orig
n_shards = len(params['blocks']['attn']['wq'].sharding.device_set)

# the compressed all-reduce over 'pod' (test_compressed_pod_allreduce...)
cmesh = jax.make_mesh((2, 4), ('pod', 'data'), **mk)
g = jnp.asarray(np.random.default_rng(0).normal(size=(8, 64)) * 0.01,
                jnp.float32)
grads = {'w': g}
spec = {'w': P('pod', None)}
fn = shard_map(lambda a, e: compressed_psum_tree(a, e, 'pod'), mesh=cmesh,
               in_specs=(spec, spec), out_specs=(spec, spec))
mean, err = fn(grads, ef_state_init(grads))
np.savez(work / "ref_compress.npz", mean=np.asarray(mean['w']),
         err=np.asarray(err['w']))

# a checkpoint saved from a (4, 2) mesh (test_elastic_remesh_roundtrip)
tree = {'w': jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
        'b': jnp.ones((8,))}
m8 = jax.make_mesh((4, 2), ('data', 'model'), **mk)
placed = reshard_tree(tree, m8, {'w': P('data', 'model'), 'b': P('data')})
CheckpointManager(str(work / "ref_ckpt"), keep=2).save(1, placed)
print(json.dumps({'losses': losses, 'n_shards': n_shards,
                  'rows': [sorted(r) for r in rows]}))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    work = tmp_path_factory.mktemp("scaleout_ref")
    code = f"BATCH, SEQ, STEPS = {B8}, {S8}, {STEPS8}\n" + REF_SCRIPT
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code, str(work)],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["work"] = work
    return out


def ref_tree(path: Path) -> dict:
    tree: dict = {}
    with np.load(path) as f:
        for name in f.files:
            *keys, leaf = name.split(".")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = f[name]
    return tree


# ---------------------------------------------------------------------------
# the port's rank drills
# ---------------------------------------------------------------------------

DRILL_SCRIPT = r'''
import hashlib, json, sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def code_rows(rows):
    """Record the last-axis rows of every fake-quant code array of a
    forward pass (their hashes) into ``rows``; returns the undo."""
    import repro_torch.quant.quantizers as Q
    orig = Q.quantize_int

    def rec(*a, **k):
        q, s = orig(*a, **k)
        if torch._C._current_graph_task_id() == -1:
            r = q.reshape(-1, q.shape[-1]).numpy()
            rows.update(hashlib.blake2b(x.tobytes(), digest_size=8)
                        .hexdigest() for x in r)
        return q, s

    Q.quantize_int = rec
    return lambda: setattr(Q, "quantize_int", orig)


def ref_params(path):
    tree = {}
    with np.load(path) as f:
        for name in f.files:
            *keys, leaf = name.split(".")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = f[name]
    return tree


def eight(rank, world, work):
    from repro_torch.ckpt import CheckpointManager, reshard_tree
    from repro_torch.configs import smoke_config
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import (adamw_init, compressed_all_reduce_tree,
                                   constant_lr, ef_state_init)
    from repro_torch.parallel.sharding import rules_for_mesh
    from repro_torch.parallel.zero import full_value, shard_model
    from repro_torch.train import make_train_step

    cfg = smoke_config("llama3.2-3b")
    api = get_model(cfg)
    mesh = make_host_mesh((2, 4), device_type="cpu")
    model = model_params_from_numpy(cfg, ref_params(work / "ref_params.npz"),
                                    device="cpu")
    shard_model(model, mesh, rules_for_mesh(mesh, cfg.sharding_overrides))
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(api, constant_lr(3e-3), mesh=mesh)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                        global_batch=BATCH))
    rows, losses = [], []
    for i in range(STEPS):
        rows.append(set())
        undo = code_rows(rows[-1])
        model, opt, m = step(model, opt, corpus.batch(i))
        undo()
        losses.append(float(m["loss"]))
    wq = model.blocks[0].attn.wq.w.to_local()
    pieces = [None] * world
    dist.all_gather_object(pieces, hashlib.blake2b(
        wq.detach().numpy().tobytes(), digest_size=8).hexdigest())

    # the compressed all-reduce over the pod groups
    cmesh = make_host_mesh((2, 4), ("pod", "data"), device_type="cpu")
    pod = cmesh.get_local_rank(0)
    g = np.asarray(np.random.default_rng(0).normal(size=(8, 64)) * 0.01,
                   np.float32)
    grads = {"w": torch.tensor(g[4 * pod:4 * pod + 4])}
    mean, err = compressed_all_reduce_tree(grads, ef_state_init(grads),
                                           cmesh.get_group("pod"))

    # elastic: place on a (4, 2) mesh, save the global arrays
    emesh = make_host_mesh((4, 2), device_type="cpu")
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8)}
    placed = reshard_tree(tree, emesh, SPEC)
    n_dev = [None] * world
    dist.all_gather_object(n_dev, placed["w"].to_local().numpy().tobytes())
    glob = {k: full_value(v) for k, v in placed.items()}
    if rank == 0:
        CheckpointManager(str(work / "port_ckpt"), keep=2).save(1, glob)
    return {"losses": losses, "rows": [sorted(r) for r in rows],
            "pieces": pieces,
            "pod": pod, "mean": mean["w"].numpy().tobytes().hex(),
            "err": err["w"].numpy().tobytes().hex(),
            "n_dev": len(set(n_dev))}


def four(rank, world, work):
    from repro_torch.ckpt import CheckpointManager, reshard_tree
    from repro_torch.configs import list_archs, smoke_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import constant_lr
    from repro_torch.parallel import sharding
    from repro_torch.parallel.zero import distribute, full_value
    from repro_torch.train import init_train_state, make_train_step
    from torch.distributed.tensor import Replicate

    mesh = make_host_mesh((2, 2), device_type="cpu")
    out = {}
    for arch in list_archs():
        cfg = smoke_config(arch)
        api = get_model(cfg)
        model, opt = init_train_state(api, torch.Generator().manual_seed(0),
                                      device="cpu", mesh=mesh)
        step = make_train_step(api, constant_lr(1e-3), mesh=mesh)
        batch = corpus_of(cfg, B4, S4).batch(0)
        rows = set()
        undo = code_rows(rows)
        model, opt, m = step(model, opt, batch)
        undo()
        moments = {n: full_value(t).numpy() for n, t in opt["m"].items()}
        if rank == 0:
            np.savez(work / f"m_{arch}.npz", **moments)
        out[arch] = {"grad_norm": float(m["grad_norm"]),
                     "aux": float(m["aux"]), "loss": float(m["loss"]),
                     "rows": sorted(rows)}

    # a MoE batch whose 256-token groups span the data ranks
    cfg = smoke_config(MOE_SPAN)
    api = get_model(cfg)
    model, opt = init_train_state(api, torch.Generator().manual_seed(0),
                                  device="cpu", mesh=mesh)
    rows = set()
    undo = code_rows(rows)
    model, opt, m = make_train_step(api, constant_lr(1e-3), mesh=mesh)(
        model, opt, corpus_of(cfg, *SPAN).batch(0))
    undo()
    moments = {n: full_value(t).numpy() for n, t in opt["m"].items()}
    if rank == 0:
        np.savez(work / "m_span.npz", **moments)
    out["span"] = {"grad_norm": float(m["grad_norm"]),
                   "aux": float(m["aux"]), "loss": float(m["loss"]),
                   "rows": sorted(rows)}

    # a MoE served over the batch ranks: its token groups span them
    from repro_torch.models import model_class
    from repro_torch.parallel.zero import (data_parallel, gather_rows,
                                           shard_model)
    cfg = smoke_config(MOE_SERVE)
    model = shard_model(model_class(cfg)(cfg, device="meta"), mesh,
                        sharding.rules_for_mesh(mesh, cfg.sharding_overrides),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    r = mesh.get_local_rank(0)
    with data_parallel(mesh, ("data",)):
        logits = serve_logits(get_model(cfg), model,
                              moe_prompts(cfg)[2 * r:2 * r + 2])
    logits = [gather_rows(x, mesh, ("data",)).numpy() for x in logits]
    if rank == 0:
        np.savez(work / "moe_serve.npz", *logits)

    # constrain_act on a DTensor
    rules = sharding.rules_for_mesh(mesh)
    x = distribute(torch.arange(4 * 6 * 8, dtype=torch.float32)
                   .reshape(4, 6, 8), mesh, [Replicate(), Replicate()])
    tok = sharding.activation_rules(rules)
    try:
        y = sharding.constrain_act(x, ("batch", "seq", "act_embed"))
        z = sharding.constrain_act(x, ("batch", "seq", "act_heads"))
    finally:
        sharding.reset_activation_rules(tok)
    out["constrain"] = [repr(p) for p in y.placements] + \
        [repr(p) for p in z.placements]
    out["constrain_local"] = list(z.to_local().shape)
    out["constrain_same"] = bool(torch.equal(full_value(z),
                                             full_value(x)))

    # elastic: restore the (4, 2) checkpoints onto (2, 2)
    out["restore"] = restore(work, mesh)
    return out


def restore(work, mesh):
    from repro_torch.ckpt import CheckpointManager, reshard_tree
    from repro_torch.parallel.zero import full_value

    got = {}
    for name in ("port_ckpt", "ref_ckpt"):
        mgr = CheckpointManager(str(work / name), keep=2)
        tree, step = mgr.restore({"b": 0, "w": 0})
        placed = reshard_tree(tree, mesh, SPEC)
        want = np.arange(64, dtype=np.float32).reshape(8, 8)
        got[name] = {
            "step": step,
            "same": bool(np.array_equal(full_value(placed["w"]).numpy(),
                                        want)
                         and np.array_equal(full_value(placed["b"]).numpy(),
                                            np.ones(8))),
            "local": list(placed["w"].to_local().shape)}
    return got


def two(rank, world, work):
    from repro_torch.launch.mesh import make_host_mesh
    return {"restore": restore(work, make_host_mesh((2, 1),
                                                    device_type="cpu"))}


def moe_prompts(cfg):
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 8)))


def serve_logits(api, model, prompts, steps=3):
    """The logits of a prefill of ``prompts`` and ``steps`` greedy decode
    steps."""
    from repro_torch.serve import make_decode_step, make_prefill
    from repro_torch.serve.step import greedy_argmax
    logits, state = make_prefill(api, prompts.shape[1] + steps + 1)(
        model, prompts, None)
    out = [logits]
    for _ in range(steps):
        logits, state = make_decode_step(api)(model, state,
                                              greedy_argmax(logits))
        out.append(logits)
    return out


def corpus_of(cfg, batch, seq):
    from repro_torch.data import DataConfig, SyntheticCorpus
    return SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch,
        frontend_tokens=cfg.frontend.n_tokens if cfg.frontend else 0,
        frontend_dim=cfg.frontend.d_frontend if cfg.frontend else 0))


def worker(rank, world, work, what):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/init_{what}",
                            rank=rank, world_size=world)
    try:
        res = globals()[what](rank, world, Path(work))
        (Path(work) / f"{what}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    what, world, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(worker, args=(world, work, what), nprocs=world, join=True)
'''


def _drill(reference, what: str, world: int) -> list[dict]:
    work = reference["work"]
    script = work / "drill.py"
    if not script.exists():
        script.write_text(
            f"BATCH, SEQ, STEPS, B4, S4 = {B8}, {S8}, {STEPS8}, {B4}, {S4}\n"
            "SPEC = {'w': ('data', 'model'), 'b': ('data',)}\n"
            f"MOE_SERVE, MOE_SPAN, SPAN = {MOE_SERVE!r}, {MOE_SPAN!r}, "
            f"{SPAN!r}\n"
            + DRILL_SCRIPT)
    r = subprocess.run([sys.executable, str(script), what, str(world),
                        str(work)], capture_output=True, text=True,
                       timeout=600, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads((work / f"{what}_{i}.json").read_text())
            for i in range(world)]


@pytest.fixture(scope="module")
def eight(reference):
    return _drill(reference, "eight", 8)


@pytest.fixture(scope="module")
def four(reference, eight):          # restores what ``eight`` saved
    return _drill(reference, "four", 4)


@pytest.fixture(scope="module")
def two(reference, eight):
    return _drill(reference, "two", 2)


def _code_rows(rows: set):
    """The one-device counterpart of the drill's ``code_rows``."""
    import repro_torch.quant.quantizers as Q
    orig = Q.quantize_int

    def rec(*a, **k):
        q, s = orig(*a, **k)
        if torch._C._current_graph_task_id() == -1:
            for x in q.reshape(-1, q.shape[-1]).numpy():
                rows.add(hashlib.blake2b(x.tobytes(),
                                         digest_size=8).hexdigest())
        return q, s

    Q.quantize_int = rec
    return lambda: setattr(Q, "quantize_int", orig)


@pytest.fixture(scope="module")
def one_device_8(reference):
    """The port's one-device run of the 8-step scenario: losses and step
    0's code rows."""
    cfg = smoke_config("llama3.2-3b")
    api = get_model(cfg)
    model = model_params_from_numpy(
        cfg, ref_tree(reference["work"] / "ref_params.npz"), device="cpu")
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(api, constant_lr(3e-3))
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=S8,
                                        global_batch=B8))
    rows, losses = [], []
    for i in range(STEPS8):
        rows.append(set())
        undo = _code_rows(rows[-1])
        model, opt, m = step(model, opt, corpus.batch(i))
        undo()
        losses.append(float(m["loss"]))
    return {"losses": losses, "rows": rows}


# ---------------------------------------------------------------------------
# the sharded train step on 8 ranks
# ---------------------------------------------------------------------------


def first_flip(ranks: list[dict], want_rows: list) -> int | None:
    """The first step at which some rank quantized a code row that the
    other run did not (a fake-quant code flipped), or None."""
    for i, want in enumerate(want_rows):
        want = set(want)
        if any(not set(r["rows"][i]) <= want for r in ranks):
            return i
    return None


def assert_loss_close(got: float, want: float, i: int, flip, what: str):
    """Within ``LOSS_TOL`` before the first code flip, ``FLIP_LOSS`` from
    it on (printed)."""
    tol = LOSS_TOL if flip is None or i < flip else FLIP_LOSS
    if tol == FLIP_LOSS:
        print(f"{what}: step {i}: a fake-quant code flipped at step {flip}; "
              f"loss {got!r} / {want!r} (rel {rel(got, want):.3g})")
    assert rel(got, want) <= tol, (what, i, flip)


class TestShardedTrainStep8:
    def test_step0_codes_agree(self, eight, one_device_8, reference):
        assert first_flip(eight, one_device_8["rows"]) != 0
        assert first_flip(eight, reference["rows"]) != 0

    @pytest.mark.parametrize("i", range(STEPS8))
    def test_loss_equals_the_reference(self, eight, reference, i):
        assert_loss_close(eight[0]["losses"][i], reference["losses"][i], i,
                          first_flip(eight, reference["rows"]),
                          "8 ranks against the reference's 8 devices")

    @pytest.mark.parametrize("i", range(STEPS8))
    def test_loss_equals_one_device(self, eight, one_device_8, i):
        assert_loss_close(eight[0]["losses"][i], one_device_8["losses"][i],
                          i, first_flip(eight, one_device_8["rows"]),
                          "8 ranks against one device")

    def test_every_rank_reports_the_same_losses(self, eight):
        assert all(r["losses"] == eight[0]["losses"] for r in eight)

    def test_loss_decreases(self, eight):
        losses = eight[0]["losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    def test_wq_is_in_eight_pieces(self, eight, reference):
        assert reference["n_shards"] == 8
        assert len(set(eight[0]["pieces"])) == 8


# ---------------------------------------------------------------------------
# every smoke config on a (2, 2) mesh against one device
# ---------------------------------------------------------------------------


def corpus_of(cfg, batch, seq):
    return SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch,
        frontend_tokens=cfg.frontend.n_tokens if cfg.frontend else 0,
        frontend_dim=cfg.frontend.d_frontend if cfg.frontend else 0))


def moe_prompts(cfg):
    """The drill's ``moe_prompts``."""
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 8)))


def serve_logits(api, model, prompts, steps=3):
    """The drill's ``serve_logits``."""
    from repro_torch.serve import make_decode_step, make_prefill
    from repro_torch.serve.step import greedy_argmax
    logits, state = make_prefill(api, prompts.shape[1] + steps + 1)(
        model, prompts, None)
    out = [logits]
    for _ in range(steps):
        logits, state = make_decode_step(api)(model, state,
                                              greedy_argmax(logits))
        out.append(logits)
    return out


class StubMesh:
    """What ``make_train_step`` reads of a one-rank ``DeviceMesh``."""

    mesh_dim_names = ("data", "model")

    def size(self, i):
        return 1

    def get_local_rank(self, i):
        return 0


class TestShardedAgainstOneDevice:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_step0_equals_one_device(self, four, reference, arch):
        cfg = smoke_config(arch)
        api = get_model(cfg)
        model, opt = init_train_state(api, torch.Generator().manual_seed(0),
                                      device="cpu")
        rows = set()
        undo = _code_rows(rows)
        try:
            _, opt, m = make_train_step(api, constant_lr(1e-3))(
                model, opt, corpus_of(cfg, B4, S4).batch(0))
        finally:
            undo()
        for r in four:
            assert set(r[arch]["rows"]) <= rows, f"{arch}: a code differs"
            assert rel(r[arch]["grad_norm"], m["grad_norm"]) <= NORM_TOL
            assert abs(r[arch]["aux"] - float(m["aux"])) <= \
                NORM_TOL * max(abs(float(m["aux"])), 1e-30)
            assert rel(r[arch]["loss"], m["loss"]) <= NORM_TOL
        with np.load(reference["work"] / f"m_{arch}.npz") as got:
            assert set(got.files) == set(opt["m"])
            for name, want in opt["m"].items():
                want = want.numpy()
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got[name] - want).max()) <= \
                    GRAD_TOL * scale, (arch, name)

    def test_a_mesh_step_needs_placed_parameters(self):
        cfg = smoke_config("llama3.2-3b")
        api = get_model(cfg)
        model, opt = init_train_state(api, torch.Generator().manual_seed(0),
                                      device="cpu")
        step = make_train_step(api, constant_lr(1e-3), mesh=StubMesh())
        with pytest.raises(ValueError, match="placed on it"):
            step(model, opt, corpus_of(cfg, 2, 8).batch(0))

    def test_moe_groups_spanning_ranks_raise(self, four, reference):
        """They no longer raise: a train step whose 256-token groups span
        the data ranks equals one device's step from the same parameters
        and batch, under the rules of :meth:`test_step0_equals_one_device`
        (the ranks compute the global groups, and the gather's backward
        returns each rank's rows' gradients to it)."""
        cfg = smoke_config(MOE_SPAN)
        api = get_model(cfg)
        model, opt = init_train_state(api, torch.Generator().manual_seed(0),
                                      device="cpu")
        rows = set()
        undo = _code_rows(rows)
        try:
            _, opt, m = make_train_step(api, constant_lr(1e-3))(
                model, opt, corpus_of(cfg, *SPAN).batch(0))
        finally:
            undo()
        assert SPAN[0] * SPAN[1] // 2 % 256, "the groups must span ranks"
        for r in four:
            got = r["span"]
            assert set(got["rows"]) <= rows, "a code differs"
            assert rel(got["grad_norm"], m["grad_norm"]) <= NORM_TOL
            assert abs(got["aux"] - float(m["aux"])) <= \
                NORM_TOL * max(abs(float(m["aux"])), 1e-30)
            assert rel(got["loss"], m["loss"]) <= NORM_TOL
        with np.load(reference["work"] / "m_span.npz") as got:
            assert set(got.files) == set(opt["m"])
            for name, want in opt["m"].items():
                want = want.numpy()
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got[name] - want).max()) <= \
                    GRAD_TOL * scale, name

    def test_moe_served_over_batch_ranks_equals_one_device(self, four,
                                                           reference):
        # prefill 4 x 8 and 3 decode steps on a (2, 2) mesh, each data
        # rank serving 2 rows: every MoE group (32 prompt tokens, then 4)
        # spans both ranks, and the ranks compute the global groups
        cfg = smoke_config(MOE_SERVE)
        api = get_model(cfg)
        model = api.init_params(torch.Generator().manual_seed(0),
                                device="cpu")
        want = [x.numpy() for x in serve_logits(api, model,
                                                moe_prompts(cfg))]
        with np.load(reference["work"] / "moe_serve.npz") as f:
            got = [f[f"arr_{i}"] for i in range(len(want))]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert float(np.abs(g - w).max()) <= \
                GRAD_TOL * float(np.abs(w).max())

    def test_constrain_act_redistributes_a_dtensor(self, four):
        for r in four:
            # ('batch', 'seq', 'act_embed'): batch over data only;
            # 'act_heads' adds the feature dim over model
            assert r["constrain"] == ["Shard(dim=0)", "Replicate()",
                                      "Shard(dim=0)", "Shard(dim=2)"]
            assert r["constrain_local"] == [2, 6, 4]
            assert r["constrain_same"]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


class TestCompressedAllReduce:
    def test_equals_the_reference_bit_for_bit(self, eight, reference):
        with np.load(reference["work"] / "ref_compress.npz") as f:
            mean, err = f["mean"], f["err"]
        for r in eight:
            p = r["pod"]
            assert bytes.fromhex(r["mean"]) == \
                np.ascontiguousarray(mean[4 * p:4 * p + 4]).tobytes()
            assert bytes.fromhex(r["err"]) == \
                np.ascontiguousarray(err[4 * p:4 * p + 4]).tobytes()


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------


class TestElastic:
    def test_saved_from_eight_pieces(self, eight):
        assert eight[0]["n_dev"] == 8

    @pytest.mark.parametrize("name", ["port_ckpt", "ref_ckpt"])
    def test_restore_onto_2x2(self, four, name):
        for r in four:
            got = r["restore"][name]
            assert got["step"] == 1 and got["same"]
            assert got["local"] == [4, 4]

    @pytest.mark.parametrize("name", ["port_ckpt", "ref_ckpt"])
    def test_restore_onto_2x1(self, two, name):
        for r in two:
            got = r["restore"][name]
            assert got["step"] == 1 and got["same"]
            assert got["local"] == [4, 8]


# ---------------------------------------------------------------------------
# the launchers under torch.distributed.run
# ---------------------------------------------------------------------------


def launch(launcher: str, args: list[str], ranks: int = 1) -> list[str]:
    run = ([] if ranks == 1 else
           ["-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(ranks)])
    r = subprocess.run([sys.executable] + run +
                       ["-m", f"repro_torch.launch.{launcher}"] + args,
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout.splitlines()


def assert_printed_close(got: str, want: str):
    """Two printed (4-decimal) losses or norms within ``LOSS_TOL`` relative
    and one unit of the last printed digit."""
    assert rel(got, want) <= LOSS_TOL + 1e-4 / abs(float(want)), (got, want)


def losses_of(lines) -> dict[int, tuple[str, str]]:
    return {int(m[1]): (m[2], m[3]) for m in
            (re.match(r"step +(\d+) loss=(\S+) gnorm=(\S+)", ln)
             for ln in lines) if m}


TRAIN = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
         "--batch", "4", "--seq", "32", "--microbatches", "2"]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("scaleout_train")
    mesh = launch("train", TRAIN + [
        "--backend", "gloo", "--mesh", "2x2", "--steps", "3",
        "--save-every", "2", "--ckpt-dir", str(d / "mesh")], ranks=4)
    one = launch("train", TRAIN + ["--steps", "3", "--save-every", "1000",
                                   "--ckpt-dir", str(d / "one")])
    resumed = launch("train", TRAIN + ["--steps", "3", "--save-every",
                                       "1000", "--ckpt-dir", str(d / "mesh")])
    resumed_2x1 = launch("train", TRAIN + [
        "--backend", "gloo", "--mesh", "2x1", "--steps", "3",
        "--save-every", "1000", "--ckpt-dir", str(d / "mesh")], ranks=2)
    return mesh, one, resumed, resumed_2x1


class TestLaunchers:
    def test_train_2x2_prints_the_1x1_losses(self, train_runs):
        mesh, one = train_runs[:2]
        assert mesh[0].startswith("mesh {'data': 2, 'model': 2}")
        got, want = losses_of(mesh), losses_of(one)
        assert sorted(got) == sorted(want) == [0, 2]
        for step in want:
            for g, w in zip(got[step], want[step]):
                assert_printed_close(g, w)

    def test_train_2x2_reports_its_mesh(self, train_runs):
        mesh = train_runs[0]
        share = [ln for ln in mesh if "share held per rank" in ln]
        assert share and share[0].endswith("[0.25, 0.25, 0.25, 0.25]")
        stats = [ln for ln in mesh if ln.startswith("mesh: ms per step")]
        assert stats and "collective bytes per rank per step" in stats[0]

    def test_saved_on_2x2_resumes_on_1x1(self, train_runs):
        _, one, resumed, _ = train_runs
        assert "resumed from step 2" in resumed
        assert losses_of(resumed)[2][0] == losses_of(one)[2][0]

    def test_saved_on_2x2_resumes_on_2x1(self, train_runs):
        # the launcher's own resume onto a mesh (reshard_tree)
        _, one, _, resumed = train_runs
        assert resumed[0].startswith("mesh {'data': 2, 'model': 1}")
        assert "resumed from step 2" in resumed
        assert sorted(losses_of(resumed)) == [2]
        for g, w in zip(losses_of(resumed)[2], losses_of(one)[2]):
            assert_printed_close(g, w)

    @pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
    def test_serve_2x1_prints_the_1x1_tokens(self, arch):
        # granite's MoE groups (4 x 8 prompt tokens, then 4 decode tokens)
        # span both batch ranks: each rank computes the global groups
        args = ["--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "4", "--prompt-len", "8", "--decode-steps", "6"]
        mesh = launch("serve", args + ["--backend", "gloo", "--mesh", "2x1"],
                      ranks=2)
        one = launch("serve", args)
        assert mesh[0].startswith(f"arch={arch}-smoke mesh={{'data': 2, "
                                  "'model': 1}")
        sample = [ln for ln in mesh if ln.startswith("sample:")]
        assert sample and \
            sample == [ln for ln in one if ln.startswith("sample:")]
