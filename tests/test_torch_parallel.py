"""The port's distribution strategy against the JAX package's, in this
process on the CPU: ``parallel.logical``, the mesh rules of
``parallel.sharding``, ``launch.specs``, ``launch.mesh``'s shrink rule,
``optim.opt_specs_like`` and the int8 compression arithmetic.  Every
comparison is exact.

* **Logical axes.**  For all ten configs, smoke and full width, the port's
  per-parameter axes (recorded where each parameter is made), with the
  reference's stacked ``layer`` axis where it stacks the blocks, equal the
  axes of ``abstract_init(api.init_params, PRNGKey(0))`` leaf by leaf, and
  the port's Logical tree has the reference's shapes and dtypes.  Nothing
  is allocated on either side (meta tensors, ``jax.eval_shape``).
* **Rules.**  ``rules_for_mesh`` and every leaf's ``logical_to_spec``
  equal the reference's on ``(data, model)``, ``(pod, data, model)`` and
  ``('spec',)`` meshes, with and without ``cfg.sharding_overrides``.  The
  reference's ``rules_for_mesh`` reads only ``axis_names``, so a stub
  stands in for its mesh; the port's reads a ``DeviceMesh``'s
  ``mesh_dim_names`` or the compiler's ``Mesh``.
* **Specs.**  ``launch.specs`` for all ten full-width configs under
  ``train_4k`` and ``decode_32k``: every meta tensor's shape and dtype and
  every spec equal the reference's ``ShapeDtypeStruct``s and
  ``PartitionSpec``s.
* **Compression.**  ``compress_int8`` and ``decompress_int8`` equal the
  reference's bit for bit, and ``tests/test_substrate.py``'s three
  compression tests hold on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import specs as JSPEC
from repro.models import get_model as jax_get_model
from repro.optim import compression as JCOMP
from repro.optim.adamw import opt_specs_like as jax_opt_specs_like
from repro.parallel import logical as JLOG
from repro.parallel import sharding as JSH

from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.launch import mesh as LM
from repro_torch.launch import specs as PSPEC
from repro_torch.models import get_model, model_class
from repro_torch.optim import (compress_int8, decompress_int8,
                               opt_specs_like)
from repro_torch.parallel import Mesh, logical, sharding
from repro_torch.parallel.logical import (Logical, abstract_init,
                                          logical_axes, logical_tree,
                                          reference_axes, split_logical)

ARCHS = list_archs()
MESHES = (("data", "model"), ("pod", "data", "model"), ("spec",))


class AxisNames:
    """What the reference's ``rules_for_mesh`` reads of a mesh."""

    def __init__(self, names):
        self.axis_names = names


class DimNames:
    """What the port's ``placements`` reads of a ``DeviceMesh``."""

    def __init__(self, names):
        self.mesh_dim_names = names


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def jax_spec(p) -> tuple:
    """A ``PartitionSpec`` as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def configs(arch, full):
    return ((jax_get_config(arch), get_config(arch)) if full
            else (jax_smoke_config(arch), smoke_config(arch)))


def jax_logical(cfg):
    tree = JLOG.abstract_init(jax_get_model(cfg).init_params,
                              jax.random.PRNGKey(0))
    return dict(flat(tree))


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------


class TestLogicalAxes:
    @pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_axes_equal_the_reference(self, arch, full):
        jcfg, cfg = configs(arch, full)
        want = {k: tuple(v.axes) for k, v in jax_logical(jcfg).items()}
        model = model_class(cfg)(cfg, device="meta")
        assert reference_axes(model) == want

    @pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_logical_tree_has_the_reference_shapes(self, arch, full):
        jcfg, cfg = configs(arch, full)
        want = jax_logical(jcfg)
        got = dict(flat(logical_tree(model_class(cfg)(cfg, device="meta")),
                        ))
        assert set(got) == set(want)
        for k, leaf in got.items():
            assert isinstance(leaf, Logical) and leaf.value.is_meta
            assert tuple(leaf.value.shape) == tuple(want[k].value.shape), k
            assert str(leaf.value.dtype).removeprefix("torch.") == \
                str(want[k].value.dtype), k
            assert leaf.axes == tuple(want[k].axes), k

    def test_every_parameter_records_its_axes(self):
        cfg = smoke_config("zamba2-1.2b")
        model = model_class(cfg)(cfg, device="meta")
        axes = logical_axes(model)
        assert set(axes) == {n for n, _ in model.named_parameters()}
        assert axes["mamba.0.conv_w"] == ("conv", "act_ff")
        assert axes["mamba.0.ln_y.g"] == ("act_ff",)
        assert axes["shared_attn.attn.wk.w"] == ("embed", "kv_heads")

    def test_a_parameter_without_axes_raises(self):
        m = torch.nn.Linear(2, 2)
        with pytest.raises(ValueError, match="records no logical axes"):
            logical_axes(m)

    def test_param_and_split_follow_the_reference(self):
        g = torch.Generator().manual_seed(0)
        tree = {"a": logical.param(g, (4, 8), ("embed", "heads")),
                "b": {"c": logical.param(None, (8,), ("act_embed",),
                                         init="ones")}}
        rules = sharding.rules_for_mesh(AxisNames(("data", "model")))
        vals, specs = split_logical(tree, rules)
        assert specs == {"a": ("data", "model"), "b": {"c": (None,)}}
        assert torch.equal(vals["b"]["c"], torch.ones(8))
        assert float(vals["a"].std()) == pytest.approx(8 ** -0.5 * 2, 0.5)
        assert logical.spec_of(tree, rules) == specs
        assert logical.values_of(tree)["a"] is vals["a"]

    def test_abstract_init_allocates_nothing(self):
        def init():
            return {"w": logical.param(None, (123_000, 4_096),
                                       ("vocab", "embed"),
                                       dtype=torch.bfloat16, init="zeros")}
        tree = abstract_init(init)
        assert tree["w"].value.is_meta
        assert tree["w"].value.dtype == torch.bfloat16
        assert tree["w"].axes == ("vocab", "embed")


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


class TestRules:
    @pytest.mark.parametrize("overrides", [False, True],
                             ids=["plain", "overrides"])
    @pytest.mark.parametrize("names", MESHES, ids="x".join)
    def test_rules_and_every_leaf_spec_equal_the_reference(self, names,
                                                           overrides):
        for arch in ARCHS:
            jcfg, cfg = configs(arch, True)
            over = cfg.sharding_overrides if overrides else None
            jover = jcfg.sharding_overrides if overrides else None
            want = JSH.rules_for_mesh(AxisNames(names), jover)
            got = sharding.rules_for_mesh(AxisNames(names), over)
            assert got == want
            # the port reads a DeviceMesh's names and the compiler's Mesh
            assert sharding.rules_for_mesh(DimNames(names), over) == want
            model = model_class(cfg)(cfg, device="meta")
            jax_axes = {k: v.axes for k, v in jax_logical(jcfg).items()}
            for ref, axes in reference_axes(model).items():
                assert sharding.logical_to_spec(axes, got) == jax_spec(
                    JSH.logical_to_spec(jax_axes[ref], want)), (arch, ref)

    def test_compiler_mesh_names(self):
        mesh = Mesh(np.array([torch.device("cpu")] * 2), ("spec",))
        assert sharding.rules_for_mesh(mesh)["spec"] == "spec"
        assert sharding.rules_for_mesh(mesh)["embed"] is None

    def test_batch_spec(self):
        for names in MESHES:
            rules = sharding.rules_for_mesh(AxisNames(names))
            assert sharding.shard_batch_spec(rules) == jax_spec(
                JSH.shard_batch_spec(JSH.rules_for_mesh(AxisNames(names))))

    def test_mesh_rules_are_the_reference_table(self):
        assert sharding.MESH_RULES == JSH.MESH_RULES

    def test_placements(self):
        mesh = DimNames(("pod", "data", "model"))
        assert sharding.placements(("data", "model"), mesh) == [
            Replicate(), Shard(0), Shard(1)]
        assert sharding.placements((("pod", "data"), None), mesh) == [
            Shard(0), Shard(0), Replicate()]
        assert sharding.placements((None,), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="twice"):
            sharding.placements(("data", "data"), mesh)
        with pytest.raises(ValueError, match="mesh's order"):
            sharding.placements((("data", "pod"),), mesh)

    def test_constrain_act_leaves_a_plain_tensor(self):
        x = torch.ones(2, 3, 4)
        tok = sharding.activation_rules(
            sharding.rules_for_mesh(AxisNames(("data", "model"))))
        try:
            assert sharding.constrain_act(x, ("batch", "seq",
                                              "act_embed")) is x
            assert sharding.constrain_act(x, ("batch",)) is x
        finally:
            sharding.reset_activation_rules(tok)
        assert sharding.constrain_act(x, ("batch", "seq", "act_embed")) is x
        assert sharding.with_sharding(x, None, (None,)) is x

    def test_opt_specs_mirror_the_params(self):
        specs = {"a": ("data", None), "b": {"c": (None,)}}
        from jax.sharding import PartitionSpec as P
        want = jax_opt_specs_like({"a": P("data", None), "b": {"c": P(None)}})
        got = opt_specs_like(specs)
        assert got["m"] == got["v"] == specs and got["count"] == ()
        assert jax_spec(want["count"]) == got["count"]


# ---------------------------------------------------------------------------
# launch.specs
# ---------------------------------------------------------------------------


def _same(jtree, ptree, jshard, pshard, what):
    J, P = dict(flat(jtree)), dict(flat(ptree))
    assert set(J) == set(P), what
    JS, PS = dict(flat(jshard)), dict(flat(pshard))
    for k in J:
        assert tuple(J[k].shape) == tuple(P[k].shape), (what, k)
        assert str(J[k].dtype) == str(P[k].dtype).removeprefix("torch."), \
            (what, k)
        assert P[k].is_meta
        assert jax_spec(JS[k].spec) == PS[k].spec, (what, k)


class TestSpecs:
    @pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_specs_equal_the_reference(self, arch, shape):
        jcfg, cfg = configs(arch, True)
        jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                  ("data", "model"))
        mesh = AxisNames(("data", "model"))
        jrules = JSH.rules_for_mesh(jmesh, jcfg.sharding_overrides)
        rules = sharding.rules_for_mesh(mesh, cfg.sharding_overrides)
        japi, api = jax_get_model(jcfg), get_model(cfg)
        jshape, pshape = JAX_SHAPES[shape], SHAPES[shape]
        if pshape.kind == "train":
            jv, js = JSPEC.abstract_params(japi, jmesh, jrules)
            pv, ps = PSPEC.abstract_params(api, mesh, rules)
            _same(jv, pv, js, ps, "params")
            jo, jos = JSPEC.abstract_opt_state(jv, js, jmesh)
            po, pos = PSPEC.abstract_opt_state(pv, ps, mesh)
            _same(jo, po, jos, pos, "opt state")
            jb = JSPEC.train_batch_specs(jcfg, jshape)
            pb = PSPEC.train_batch_specs(cfg, pshape)
            _same(jb, pb, JSPEC.batch_shardings(jcfg, jb, jmesh, jrules),
                  PSPEC.batch_shardings(cfg, pb, mesh, rules), "batch")
        else:
            jv, js = JSPEC.abstract_decode_state(japi, jshape, jmesh, jrules)
            pv, ps = PSPEC.abstract_decode_state(api, pshape, mesh, rules)
            _same(jv, pv, js, ps, "decode state")
            for fj, fp in ((JSPEC.decode_token_specs,
                            PSPEC.decode_token_specs),
                           (JSPEC.prefill_token_specs,
                            PSPEC.prefill_token_specs)):
                jt, jsh = fj(jcfg, jshape, jmesh, jrules)
                pt, psh = fp(cfg, pshape, mesh, rules)
                _same({"t": jt}, {"t": pt}, {"t": jsh}, {"t": psh}, "tokens")

    def test_the_largest_config_is_abstract(self):
        cfg = get_config("mistral-large-123b")
        vals, _ = PSPEC.abstract_params(
            get_model(cfg), AxisNames(("data", "model")),
            sharding.rules_for_mesh(AxisNames(("data", "model"))))
        n = sum(v.numel() for _, v in flat(vals))
        assert n > 120e9 and all(v.is_meta for _, v in flat(vals))


# ---------------------------------------------------------------------------
# launch.mesh
# ---------------------------------------------------------------------------


class TestMeshRule:
    def test_shrinks_to_the_world(self):
        assert LM.mesh_shape((2, 4), ("data", "model"), 1) == {
            "data": 1, "model": 1}
        assert LM.mesh_shape((2, 4), ("data", "model"), 4) == {
            "data": 1, "model": 4}
        assert LM.mesh_shape((2, 2), ("data", "model"), 4) == {
            "data": 2, "model": 2}
        assert LM.mesh_shape((2, 2, 2), ("pod", "data", "model"), 8) == {
            "pod": 2, "data": 2, "model": 2}

    def test_one_rank_is_the_one_device_path(self):
        assert LM.make_host_mesh((2, 4)) == {"data": 1, "model": 1}
        assert LM.mesh_dims({"data": 1, "model": 1}) == {"data": 1,
                                                         "model": 1}

    def test_a_mesh_the_group_cannot_fill_raises(self, monkeypatch):
        monkeypatch.setattr(LM, "world_size", lambda: 4)
        with pytest.raises(ValueError, match="process group holds 4"):
            LM.make_host_mesh((2, 1))

    def test_parse_mesh(self):
        assert LM.parse_mesh("2x2") == ((2, 2), ("data", "model"))
        assert LM.parse_mesh("2x2x2") == ((2, 2, 2),
                                          ("pod", "data", "model"))

    def test_backend_is_a_choice(self):
        with pytest.raises(ValueError, match="backend"):
            LM.init_distributed("mpi", "cpu")

    def test_outside_torchrun_no_group_starts(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert LM.init_distributed("gloo", "cpu") == torch.device("cpu")
        assert not torch.distributed.is_initialized()
        assert LM.is_main()


# ---------------------------------------------------------------------------
# compression arithmetic
# ---------------------------------------------------------------------------


RNG = np.random.default_rng(0)


class TestCompression:
    @pytest.mark.parametrize("scale", [0.01, 1.0, 1e-20])
    def test_compress_equals_the_reference_bit_for_bit(self, scale):
        g = RNG.normal(size=(257,)).astype(np.float32) * np.float32(scale)
        e = RNG.normal(size=(257,)).astype(np.float32) * np.float32(scale
                                                                    / 100)
        jq, js, je = JCOMP.compress_int8(jnp.asarray(g), jnp.asarray(e))
        q, s, err = compress_int8(torch.tensor(g), torch.tensor(e))
        assert q.dtype == torch.int8
        assert np.array_equal(np.asarray(jq), q.numpy())
        assert np.asarray(js).tobytes() == s.numpy().tobytes()
        assert np.asarray(je).tobytes() == err.numpy().tobytes()

    def test_decompress_equals_the_reference(self):
        q = RNG.integers(-254, 255, size=(64,)).astype(np.int32)
        want = JCOMP.decompress_int8(jnp.asarray(q), jnp.float32(0.0371), 2)
        got = decompress_int8(torch.tensor(q), torch.tensor(0.0371), 2)
        assert np.asarray(want).tobytes() == got.numpy().tobytes()

    # tests/test_substrate.py's TestCompression on the port
    def test_error_feedback_reduces_bias(self):
        g = torch.tensor(RNG.normal(size=(512,)) * 0.01, dtype=torch.float32)
        err = torch.zeros_like(g)
        acc = torch.zeros_like(g)
        for _ in range(50):
            q, s, err = compress_int8(g, err)
            acc = acc + q.to(torch.float32) * s
        np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=5e-4)

    def test_compress_bounds(self):
        g = torch.tensor(RNG.normal(size=(64,)), dtype=torch.float32)
        q, s, e = compress_int8(g, torch.zeros_like(g))
        assert q.dtype == torch.int8
        rec = q.to(torch.float32) * s
        assert float((rec - g).abs().max()) <= float(s) * 0.5 + 1e-7

    def test_decompress_int8_mean(self):
        q_sum = torch.tensor([100, -100], dtype=torch.int32)
        out = decompress_int8(q_sum, torch.tensor(0.02), 2)
        np.testing.assert_allclose(out.numpy(), [1.0, -1.0])

    def test_spec_string_is_the_reference(self):
        from repro_torch.optim import compressed_allreduce_spec
        assert compressed_allreduce_spec() == \
            JCOMP.compressed_allreduce_spec()
