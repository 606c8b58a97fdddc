"""The DCIM fake-quant's CUDA kernel (``csrc/fake_quant.cu``, bound in
``repro_torch.kernels.fake_quant``) and its route in
``repro_torch.quant.quantizers.fake_quant``.

On the CPU: the route (CPU tensors take the plain version,
``quantize_int``, at any bits and dtype; every CUDA tensor the kernel,
through ``_FakeQuant``), what the binding refuses (bits above 8, other
dtypes), the span's ``kernel`` tag, the straight-through gradient, the
launch plan's geometry, and the kernel's arithmetic written out in float32
torch ops that round to the input's dtype where the kernel does, held bit
for bit against the plain version (the order of its roundings, the double
rounding of a quotient that lands on x.5 only in bfloat16 included).

On the card (``cuda`` marker; skipped where none is visible): the kernel
bit for bit against the plain version run on the card, result and int8
codes, at the cells' operand shapes for bfloat16, float16 and float32 and
bits 1, 2, 4 and 8; all-zero slices, NaN and inf, the half-way quotients,
strided, transposed, expanded (stride 0), misaligned and odd-width
operands; bits 16 and float64 refused, an empty operand; the
straight-through gradient; the launch counts; and a smoke decode step whose
every fake-quant ran the kernel.  The module imports neither jax nor the
JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fake_quant.py
"""

import types

import pytest
import torch

import repro_torch.quant.quantizers as Q
from repro_torch.kernels.fake_quant import LAUNCHES, fake_quant_cuda
from repro_torch.kernels.fake_quant import kernel as K
from repro_torch.obs import tracer

DTYPES = (torch.bfloat16, torch.float16, torch.float32)
BITS = (1, 2, 4, 8)
_INT = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
        torch.float32: torch.int32}

# (shape, axis): the decode cells' operands.  Granite: a token's
# activation row, the experts' input, a K/V projection's weight, the
# experts' gate/up and down weights; zamba2: the Mamba2 input projection's
# activation and weight.
LAYOUTS = [((1024, 1536), -1), ((40, 4, 64, 1536), -1), ((1536, 512), 0),
           ((40, 1536, 512), 1), ((40, 512, 1536), 1), ((2048, 8384), -1),
           ((2048, 8384), 0)]


def _name(v):
    return str(v).replace("torch.", "")


def _bits_of(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(_INT[t.dtype])


def _same_on_cpu(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, but any NaN equal to any NaN: on the CPU a NaN's sign
    and payload depend on whether aten's vector loop or its scalar tail
    rounded it (bits 1 makes every slice NaN: 0 x inf)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        _bits_of(a)[~nan], _bits_of(b)[~nan])


def _operand(shape, dtype, axis, seed, device="cpu"):
    """Normal values, each slice scaled by its own factor (2^-8..2^8), so
    the slices' scales differ."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    if axis is not None:
        keep = list(shape)
        keep[axis] = 1
        x = x * torch.exp2(8 * (2 * torch.rand(keep, generator=g,
                                               device=device) - 1))
    return x.to(dtype)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, written out (CPU)
# ---------------------------------------------------------------------------


def _emulated(x: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """What ``csrc/fake_quant.cu`` computes, in float32 torch ops: the max
    of |x| taken on its bits, every other step rounded to x's dtype where
    the kernel's ``rnd`` is."""
    dt, f32 = x.dtype, torch.float32

    def rnd(v):
        return v.to(dt).to(f32)

    xf = x.to(f32)
    amax = xf.abs().view(torch.int32).amax(axis, keepdim=True).view(f32)
    floor = torch.tensor(K.floor_value(dt))
    qmax = torch.tensor(float((1 << (bits - 1)) - 1))
    m = torch.where(torch.isnan(amax) | (amax > floor), amax, floor)
    scale = rnd(m / qmax)
    q = torch.round(rnd(xf / scale))
    q = torch.where(torch.isnan(q), q, q.clamp(-qmax - 1, qmax))
    return (q.to(torch.int8).to(f32) * scale).to(dt)


@pytest.mark.parametrize("axis", (-1, 0, 1))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
def test_kernel_arithmetic_is_the_plain_versions(dtype, bits, axis):
    x = _operand((48, 40, 72), dtype, axis, 7)
    want = Q._fake_quant_ref(x, bits, axis)
    assert _same_on_cpu(_emulated(x, bits, axis), want)


def _half_way(dtype) -> torch.Tensor:
    """Rows whose amax is 100 and whose other values x have a quotient
    x / scale that is no half in float32 but rounds to one in ``dtype``:
    rint of the rounded quotient (the plain version's) and of the float32
    one give other codes on some of them."""
    nbits = 16
    pat = torch.arange(1 << nbits, dtype=torch.int32).to(torch.int16)
    vals = pat.view(dtype).to(torch.float32)
    vals = vals[torch.isfinite(vals) & (vals > 0.25) & (vals < 100)]
    scale = (torch.tensor(100.0, dtype=dtype)
             / torch.tensor(127.0, dtype=dtype)).to(torch.float32)
    q32 = vals / scale
    qt = q32.to(dtype).to(torch.float32)
    pick = vals[(qt - qt.floor() == 0.5) & (q32 != qt)]
    row = torch.cat([torch.tensor([100.0]), pick, -pick])
    return row.expand(4, -1).to(dtype).contiguous()


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16),
                         ids=_name)
def test_half_way_quotients_round_twice(dtype):
    x = _half_way(dtype)
    assert x.shape[1] > 20
    q, s = Q.quantize_int(x, 8, -1)
    single = torch.round(x.float() / s).clamp(-128, 127).to(torch.int8)
    assert (q != single).any()              # the case is exercised
    assert torch.equal(_bits_of(_emulated(x, 8, -1)),
                       _bits_of(Q._fake_quant_ref(x, 8, -1)))


# ---------------------------------------------------------------------------
# the route (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,want", [
    ((True, torch.bfloat16, 8), True), ((True, torch.float16, 1), True),
    ((True, torch.float32, 4), True), ((True, torch.bfloat16, 16), True),
    ((True, torch.float64, 8), True), ((False, torch.bfloat16, 8), False),
    ((False, torch.float32, 8), False)], ids=str)
def test_route_by_input(case, want):
    # the device alone routes: the card's kernel raises on bits 16 and
    # float64 (test_binding_refuses_what_it_does_not_take)
    cuda, dtype, bits = case
    x = types.SimpleNamespace(is_cuda=cuda, dtype=dtype, bits=bits)
    assert Q._takes_kernel(x) is want


@pytest.fixture
def quiet_tracer():
    clock = tracer.clock
    tracer.configure(enabled=False)
    tracer.clear()
    yield
    tracer.configure(enabled=False, clock=clock)
    tracer.clear()


def _traced_fake_quant(x, bits, axis):
    tracer.configure(enabled=True)
    with tracer.start_trace("root"):
        y = Q.fake_quant(x, bits, axis)
    tracer.configure(enabled=False)
    return y, [s for s in tracer.spans() if s.name == "fake_quant"]


@pytest.mark.parametrize("bits", (8, 16))
@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
def test_cpu_takes_the_plain_version(dtype, bits, monkeypatch, quiet_tracer):
    def refused(*a):
        raise AssertionError("the kernel route ran on the CPU")

    monkeypatch.setattr(Q, "_fake_quant_kernel", refused)
    x = _operand((6, 40), dtype, -1, 3)
    y, spans = _traced_fake_quant(x, bits, -1)
    assert torch.equal(_bits_of(y), _bits_of(Q._fake_quant_ref(x, bits, -1)))
    assert [s.tags for s in spans] == [{"kernel": False}]


def _routed_to_kernel(monkeypatch):
    """Route every input to a stand-in kernel (the plain version on the
    CPU) that records its calls."""
    calls = []

    def kernel(x, bits, axis):
        calls.append(torch.is_grad_enabled())
        return Q._fake_quant_ref(x, bits, axis)

    monkeypatch.setattr(Q, "_takes_kernel", lambda x: True)
    monkeypatch.setattr(Q, "_fake_quant_kernel", kernel)
    return calls


def test_kernel_route_is_tagged(monkeypatch, quiet_tracer):
    calls = _routed_to_kernel(monkeypatch)
    x = _operand((6, 40), torch.float32, 0, 4)
    y, spans = _traced_fake_quant(x, 8, 0)
    assert calls and [s.tags for s in spans] == [{"kernel": True}]
    assert torch.equal(y, Q._fake_quant_ref(x, 8, 0))


@pytest.mark.parametrize("grad", ("no_grad", "no_requires_grad", "grad"))
def test_kernel_route_with_and_without_autograd(grad, monkeypatch):
    calls = _routed_to_kernel(monkeypatch)
    x = _operand((6, 40), torch.float32, -1, 5)
    if grad == "grad":
        x.requires_grad_(True)
    with torch.no_grad() if grad == "no_grad" else torch.enable_grad():
        y = Q.fake_quant(x, 8, -1)
    # through _FakeQuant, whose forward runs with autograd off
    assert calls == [False]
    assert torch.equal(y.detach(), Q._fake_quant_ref(x.detach(), 8, -1))
    if grad != "grad":
        assert y.grad_fn is None            # no graph is recorded
        return
    assert y.grad_fn is not None
    (y * 3.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
def test_straight_through_gradient_on_the_plain_route(dtype):
    x = _operand((8, 24), dtype, -1, 6).requires_grad_(True)
    (Q.fake_quant(x, 4, -1) * 3.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


@pytest.mark.parametrize("dtype,bits,error,says", [
    (torch.float32, 8, ValueError, "CUDA tensor"),
    (torch.bfloat16, 16, ValueError, "bits 1..8"),
    (torch.float16, 0, ValueError, "bits 1..8"),
    (torch.float64, 8, TypeError, "float32, bfloat16 or float16"),
    (torch.int32, 8, TypeError, "float32, bfloat16 or float16")], ids=str)
def test_binding_refuses_what_it_does_not_take(dtype, bits, error, says):
    # dtype and bits are checked before the device, so on the CPU too
    with pytest.raises(error, match=says):
        fake_quant_cuda(torch.zeros(4, 8, dtype=dtype), bits, -1)


# ---------------------------------------------------------------------------
# the launch plan (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
@pytest.mark.parametrize("shape,axis", LAYOUTS + [
    ((7, 33), 0), ((5, 37), -1), ((3, 1, 2), 1), ((9,), 0), ((100_000, 8), 0),
    ((70_000, 3, 64), 1), ((6, 10), None), ((), -1)], ids=str)
def test_launch_plan_covers_every_slice(shape, axis, dtype):
    x = torch.empty(shape, dtype=dtype)
    x2, pl = K.launch_plan(x, axis)
    full = 16 // x.element_size()
    n = x.numel()
    assert pl.outer * pl.R * pl.inner == n
    if axis is None or not shape:
        assert (pl.route, pl.outer, pl.R) == ("rows", 1, n)
    else:
        assert pl.R == shape[axis]
    assert pl.vec in (1, full)
    if pl.route == "rows":
        assert pl.inner == 1 and x2.numel() == n
        assert 32 <= pl.threads <= K.ROW_MAX_THREADS and pl.threads % 32 == 0
        assert pl.vec == 1 or (pl.R % full == 0 and pl.ld % full == 0)
        # a row of up to ROW_KEEP vectors a thread is held whole
        held = pl.threads * K.ROW_KEEP * pl.vec
        assert held >= pl.R or pl.threads == K.ROW_MAX_THREADS
        return
    assert pl.inner > 1 and x2.is_contiguous()
    assert pl.vec == 1 or pl.inner % full == 0
    tx = 8 if pl.vec > 1 else 32
    cw, ty = tx * pl.vec, K.COL_THREADS // tx
    assert (pl.tiles - 1) * cw < pl.inner <= pl.tiles * cw
    assert 1 <= pl.parts <= K.MAX_CLUSTER
    assert pl.rows_per == -(-pl.R // pl.parts)
    assert pl.grid_y == min(pl.outer, K.GRID_Y)
    # parts split a long R into rows held in registers, or fill the card
    if pl.parts < K.MAX_CLUSTER and pl.parts < -(-pl.R // ty):
        assert pl.rows_per <= K.COL_KEEP * ty
        assert pl.tiles * pl.grid_y * pl.parts >= K.FILL_BLOCKS


def test_launch_plan_reads_strided_rows_in_place():
    big = torch.zeros(64, 2048, dtype=torch.bfloat16)
    x2, pl = K.launch_plan(big[:, :1536], -1)
    assert x2.data_ptr() == big.data_ptr() and pl.ld == 2048 and pl.vec == 8
    # leading dims that collapse into one row stride, and ones that do not
    big3 = torch.zeros(4, 8, 2048, dtype=torch.float32)
    x2, pl = K.launch_plan(big3[:, :, :1536], -1)
    assert x2.data_ptr() == big3.data_ptr() and pl.ld == 2048
    assert (pl.outer, pl.R, pl.vec) == (32, 1536, 4)
    x2, pl = K.launch_plan(big3[:, ::2, :1536], -1)
    assert x2.data_ptr() == big3.data_ptr() and pl.ld == 4096
    x2, pl = K.launch_plan(big3[:, :4, :1536], -1)
    assert x2.is_contiguous() and pl.ld == 1536 and pl.outer == 16
    # a transposed weight is made contiguous for the cols route
    w = torch.zeros(512, 1536, dtype=torch.bfloat16).t()
    x2, pl = K.launch_plan(w, 0)
    assert x2.is_contiguous() and pl.route == "cols" and pl.vec == 8
    # a misaligned operand loads one element at a time
    flat = torch.zeros(64 * 1536 + 1, dtype=torch.bfloat16)
    _, pl = K.launch_plan(flat[1:].view(64, 1536), -1)
    assert pl.vec == 1
    _, pl = K.launch_plan(flat[1:].view(1536, 64), 0)
    assert pl.vec == 1


def test_launch_plan_copies_expanded_operands():
    # every dim of stride 0: one element in storage, made contiguous
    one = torch.tensor(1.5, dtype=torch.bfloat16)
    for shape, axis in (((40, 1536, 512), 1), ((1536, 512), 0)):
        x2, pl = K.launch_plan(one.expand(*shape), axis)
        assert pl.route == "cols" and x2.is_contiguous()
        assert x2.untyped_storage().nbytes() == x2.numel() * 2
    x2, pl = K.launch_plan(one.expand(64, 1536), -1)
    assert pl.route == "rows" and x2.is_contiguous() and pl.ld == 1536
    # one row repeated: read where it lies, every row at offset 0
    row = torch.zeros(1536, dtype=torch.bfloat16)
    x2, pl = K.launch_plan(row.expand(64, -1), -1)
    assert x2.data_ptr() == row.data_ptr()
    assert (pl.route, pl.outer, pl.ld, pl.vec) == ("rows", 64, 0, 8)
    x2, pl = K.launch_plan(row[:512].expand(1536, -1), 0)
    assert pl.route == "cols" and x2.is_contiguous()


def test_floor_values_are_the_plain_versions():
    assert K.floor_value(torch.float16) == 0.0
    assert K.EPS == Q.quantize_int.__defaults__[-1]
    for dt in DTYPES:
        assert K.floor_value(dt) == torch.tensor(1e-8, dtype=dt).item()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _same_as_plain(x, bits, axis):
    """The kernel's result and codes against the plain version's on the
    card, bit for bit."""
    got, codes = fake_quant_cuda(x, bits, axis, codes=True)
    q, _ = Q.quantize_int(x, bits, axis)
    want = Q._fake_quant_ref(x, bits, axis)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(_bits_of(got), _bits_of(want)), (x.shape, axis, bits)
    assert torch.equal(codes, q), (x.shape, axis, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", LAYOUTS, ids=str)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
def test_kernel_bitwise(dtype, bits, shape, axis, card):
    _same_as_plain(_operand(shape, dtype, axis, 11, card), bits, axis)


def _edge(case, dtype, device):
    """(operand, axis) of an edge case."""
    x = _operand((256, 1536), dtype, -1, 13, device)
    if case == "zero_rows":
        x[::3] = 0
        return x, -1
    if case == "zero_cols":
        x[:, ::5] = 0
        return x, 0
    if case in ("nan", "inf"):
        v = float(case)
        x[3, 7], x[100, 1535], x[200, 0] = v, -v, v
        return x, -1 if case == "nan" else 0
    if case == "half_way":
        if dtype == torch.float32:
            return _half_way(torch.bfloat16).float().to(device), -1
        return _half_way(dtype).to(device), -1
    if case == "half_way_cols":
        if dtype == torch.float32:
            return _half_way(torch.bfloat16).float().t().contiguous().to(
                device), 0
        return _half_way(dtype).t().contiguous().to(device), 0
    if case == "strided_rows":
        return _operand((256, 2048), dtype, -1, 14, device)[:, 8:1544], -1
    if case == "strided_rows_3d":           # rows 4096 apart, one stride
        return _operand((8, 32, 2048), dtype, -1, 22, device)[:, ::2,
                                                              8:1544], -1
    if case == "transposed":
        return _operand((512, 1536), dtype, 1, 15, device).t(), 0
    if case == "misaligned":
        flat = _operand((256 * 1536 + 1,), dtype, None, 16, device)
        return flat[1:].view(256, 1536), -1
    if case == "misaligned_cols":
        flat = _operand((1536 * 64 + 1,), dtype, None, 17, device)
        return flat[1:].view(1536, 64), 0
    if case == "odd_width":
        return _operand((7, 1000, 33), dtype, 1, 18, device), 1
    if case == "many_outer":                # grid.y walks the outer index
        return _operand((70_000, 3, 8), dtype, 1, 20, device), 1
    if case == "scalar":
        return torch.tensor(-2.5, dtype=dtype, device=device), -1
    if case == "expanded":                  # one element, stride 0
        one = _operand((1,), dtype, None, 25, device)[0]
        return one.expand(40, 96, 64), 1
    if case == "expanded_rows":             # one row, stride 0
        return _operand((1536,), dtype, None, 26, device).expand(256, -1), -1
    if case == "expanded_cols":
        return _operand((1536,), dtype, None, 27, device).expand(256, -1), 0
    if case == "whole_tensor":
        return _operand((64, 96), dtype, None, 19, device), None
    raise ValueError(case)


EDGES = ("zero_rows", "zero_cols", "nan", "inf", "half_way",
         "half_way_cols", "strided_rows", "strided_rows_3d", "transposed",
         "misaligned", "misaligned_cols", "odd_width", "many_outer",
         "scalar", "whole_tensor", "expanded", "expanded_rows",
         "expanded_cols")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES)
@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
def test_kernel_edge_cases(dtype, case, card):
    x, axis = _edge(case, dtype, card)
    for bits in (1, 8):
        _same_as_plain(x, bits, axis)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=_name)
def test_kernel_straight_through_gradient(dtype, card):
    x = _operand((64, 1536), dtype, -1, 21, card).requires_grad_(True)
    before = dict(LAUNCHES)
    y = Q.fake_quant(x, 8, -1)
    assert LAUNCHES["rows"] == before["rows"] + 1
    assert torch.equal(_bits_of(y.detach()),
                       _bits_of(Q._fake_quant_ref(x.detach(), 8, -1)))
    (y * 3.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


@pytest.mark.cuda
def test_kernel_launch_counts(card):
    before = dict(LAUNCHES)
    with torch.no_grad():
        for shape, axis in LAYOUTS:
            Q.fake_quant(_operand(shape, torch.bfloat16, axis, 23, card), 8,
                         axis)
    torch.cuda.synchronize()
    rows = sum(1 for s, a in LAYOUTS if a == -1)
    assert LAUNCHES == {"rows": before["rows"] + rows,
                        "cols": before["cols"] + len(LAYOUTS) - rows}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("bits_16", "float64", "empty"))
def test_card_outside_the_kernels_domain(case, card):
    # no plain version on the card: bits 16 and float64 raise, naming the
    # limit; an empty operand gives an empty result without a launch
    x = _operand((4, 8), torch.bfloat16, -1, 24, card)
    before = dict(LAUNCHES)
    if case == "bits_16":
        with pytest.raises(ValueError, match="bits 1..8"):
            Q.fake_quant(x, 16, -1)
    elif case == "float64":
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            Q.fake_quant(x.double(), 8, -1)
    else:
        for axis in (-1, 0, None):
            y = Q.fake_quant(x[:0], 8, axis)
            assert y.shape == (0, 8) and y.dtype == x.dtype and y.is_cuda
    assert LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m", "zamba2-1.2b"))
def test_decode_step_runs_the_kernel(arch, card, quiet_tracer):
    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve.step import (greedy_argmax, make_decode_step,
                                        make_prefill)

    cfg = smoke_config(arch)
    api = get_model(cfg)
    model = api.init_params(torch.Generator(device=card).manual_seed(0),
                            device=card)
    prompts = torch.randint(0, cfg.vocab, (4, 8),
                            generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, state = make_prefill(api, 16)(model, prompts.to(card))
        tok = greedy_argmax(logits)
        before = sum(LAUNCHES.values())
        tracer.configure(enabled=True)
        make_decode_step(api)(model, state, tok)
        tracer.configure(enabled=False)
    torch.cuda.synchronize()
    spans = [s for s in tracer.spans() if s.name == "fake_quant"]
    assert spans and all(s.tags == {"kernel": True} for s in spans)
    assert sum(LAUNCHES.values()) - before == len(spans)
