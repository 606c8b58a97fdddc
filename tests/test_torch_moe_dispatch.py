"""The MoE slot assignment's route and the card kernel's algorithm on the
CPU (``models.moe._top_k_dispatch``, ``kernels/moe_dispatch``).

The kernel (``csrc/moe_dispatch.cu``) has no CPU mode: its bits are held
against the plain loop on the card in ``test_torch_cuda.py``.  Here its
algorithm, written out in numpy as the source computes it (per tile of
tokens: the group's counts by slot and expert, those before the tile, the
tile's own earlier tokens), is held against the loop bit for bit; the seam
is shown to choose the kernel for CUDA gates and the loop for CPU gates;
and the load-balance loss and the gradient the kernel's route gives
(``_CardSlots``) are shown to be the same bits on either route.  No jax
is imported."""

import re
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.moe_dispatch import kernel as K
from repro_torch.models import moe
from repro_torch.models.moe import MoeBlock

# (G, S, E, k, C): granite-3b's decode (4 groups) and prefill group, an
# overflow that drops, one slot an expert, S not a multiple of 32 or of the
# tile, and a single token
SHAPES = [(4, 256, 40, 8, 64), (1, 256, 40, 8, 64), (1, 48, 4, 2, 8),
          (3, 4, 40, 8, 1), (2, 77, 40, 8, 20), (2, 37, 6, 3, 5),
          (1, 1, 8, 2, 1)]
TIE = torch.tensor([[[0.1, 0.3, 0.3, 0.2, 0.3, 0.3]]])


def _gates(g, s, e, seed=0):
    logits = torch.randn((g, s, e), generator=torch.Generator().manual_seed(
        seed)) * 2.0
    return torch.softmax(logits, dim=-1)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy().view(np.int32)


def kernel_algorithm(topv, topi, e, capacity, tile):
    """``csrc/moe_dispatch.cu`` in numpy, block by block: (dispatch,
    combine, held)."""
    ti, tv = topi.numpy(), topv.detach().numpy()
    g, s, k = ti.shape
    dispatch = np.zeros((g, s, e, capacity), bool)
    combine = np.zeros((g, s, e, capacity), np.float32)
    held = np.zeros((g, s, e), np.float32)
    for gi in range(g):
        for s0 in range(0, s, tile):
            n = min(tile, s - s0)
            # 1. the group's counts by (slot, expert), those before the tile
            total = np.zeros((k, e), np.int64)
            before = np.zeros((k, e), np.int64)
            slots = np.broadcast_to(np.arange(k), (s, k))
            np.add.at(total, (slots, ti[gi]), 1)
            np.add.at(before, (slots[:s0], ti[gi, :s0]), 1)
            # 2. the exclusive sum over the slots, plus those before
            first = np.cumsum(total, 0) - total + before
            # 3. the tile's positions
            for r in range(n):
                for j in range(k):
                    x = ti[gi, s0 + r, j]
                    pos = first[j, x] + np.sum(ti[gi, s0:s0 + r, j] == x)
                    if pos < capacity:
                        dispatch[gi, s0 + r, x, pos] = True
                        combine[gi, s0 + r, x, pos] = tv[gi, s0 + r, j]
                        held[gi, s0 + r, x] = 1.0
    return (torch.from_numpy(dispatch), torch.from_numpy(combine),
            torch.from_numpy(held))


@pytest.mark.parametrize("g,s,e,k,cap", SHAPES)
@pytest.mark.parametrize("tile", [1, 4, 32])
def test_kernel_algorithm_equals_the_loop(g, s, e, k, cap, tile):
    topv, topi = moe._top_k(_gates(g, s, e, seed=g * s + e), k)
    d, c, held = kernel_algorithm(topv, topi, e, cap, tile)
    want_d, want_c = moe._slots_ref(topv, topi, e, cap)
    assert torch.equal(d, want_d)
    np.testing.assert_array_equal(_bits(c), _bits(want_c))
    assert torch.equal(held, want_d.any(-1).to(torch.float32))
    assert int(d.sum()) == int(want_d.sum())


def test_kernel_algorithm_on_exact_ties():
    topv, topi = moe._top_k(TIE, 3)
    assert topi.tolist() == [[[1, 2, 4]]]
    d, c, _ = kernel_algorithm(topv, topi, 6, 1, 32)
    want_d, want_c = moe._slots_ref(topv, topi, 6, 1)
    assert torch.equal(d, want_d)
    np.testing.assert_array_equal(_bits(c), _bits(want_c))


@pytest.mark.parametrize("is_cuda,dtype,grad", [
    (True, torch.float32, False),             # serving on the card
    (True, torch.float32, True),              # training on the card
    (True, torch.bfloat16, False),            # the binding refuses it
    (False, torch.float32, False),            # the CPU
    (False, torch.float32, True)])
def test_route_follows_the_device(is_cuda, dtype, grad):
    gates = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                  requires_grad=grad)
    assert moe._takes_kernel(gates) is is_cuda


def test_cpu_gates_take_the_loop(monkeypatch):
    calls = []
    monkeypatch.setattr(moe, "_dispatch_kernel",
                        lambda *a: calls.append(a))
    gates = _gates(2, 16, 8).requires_grad_()
    _, combine, aux = moe._top_k_dispatch(gates, 2, 4)
    assert calls == [] and combine.requires_grad and aux.requires_grad
    with torch.no_grad():
        moe._top_k_dispatch(gates, 2, 4)
    assert calls == []


def _mock_card(monkeypatch, tile=4):
    """Route every call to the kernel, whose stand-in is
    :func:`kernel_algorithm`; the calls it took."""
    calls = []

    def kernel(topv, topi, e, capacity):
        calls.append((tuple(topi.shape), e, capacity))
        return kernel_algorithm(topv, topi, e, capacity, tile)

    monkeypatch.setattr(moe, "_takes_kernel", lambda gates: True)
    monkeypatch.setattr(moe, "_dispatch_kernel", kernel)
    return calls


@pytest.mark.parametrize("g,s,e,k,cap", SHAPES[:4])
def test_mocked_card_selects_the_kernel_with_the_same_bits(g, s, e, k, cap,
                                                           monkeypatch):
    gates = _gates(g, s, e, seed=7)
    want = moe._top_k_dispatch(gates, k, cap)
    calls = _mock_card(monkeypatch)
    got = moe._top_k_dispatch(gates, k, cap)
    assert calls == [((g, s, k), e, cap)]
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_load_balance_loss_is_unchanged(monkeypatch):
    """``forward_aux``'s loss is the Switch loss of the plain slots, bit
    for bit, on the loop and on the (mocked) kernel route alike."""
    cfg = smoke_config("granite-moe-3b-a800m")
    blk = MoeBlock(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    for p in blk.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    pos = torch.arange(16).expand(2, 16)
    with torch.no_grad():
        y, aux = blk.forward_aux(x, positions=pos)
        # the loss as the loop's dispatch gives it
        h = x + blk.attn(blk.ln_attn(x), positions=pos)
        xg = blk.ln_mlp(h).reshape(1, 32, -1)
        gates = torch.softmax(xg @ blk.moe.router, dim=-1)
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = max(1, int(np.ceil(32 * k / e * cfg.moe.capacity_factor)))
        d, _ = moe._slots_ref(*moe._top_k(gates, k), e, cap)
        density = d.any(-1).to(torch.float32).mean(dim=(0, 1))
        want = e * torch.sum(density * gates.mean(dim=(0, 1)))
        assert _bits(aux).tolist() == _bits(want).tolist()
        calls = _mock_card(monkeypatch)
        y2, aux2 = blk.forward_aux(x, positions=pos)
    assert len(calls) == 1
    assert _bits(aux2).tolist() == _bits(aux).tolist()
    np.testing.assert_array_equal(_bits(y2), _bits(y))


@pytest.mark.parametrize("g,s,e,k,cap", SHAPES[:4])
def test_mocked_card_gives_the_loops_gradient(g, s, e, k, cap, monkeypatch):
    """The gates' gradient through the kernel's route (``_CardSlots``) is
    the loop's, bit for bit, under a loss that weighs every element of
    ``combine`` and the load-balance loss."""
    gates = _gates(g, s, e, seed=5)
    w = torch.randn((g, s, e, cap), generator=torch.Generator().manual_seed(6))

    def grad():
        x = gates.clone().requires_grad_()
        _, combine, aux = moe._top_k_dispatch(x, k, cap)
        ((combine * w).sum() + aux).backward()
        return x.grad

    want = grad()
    calls = _mock_card(monkeypatch)
    got = grad()
    assert len(calls) == 1
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_block_gradient_is_unchanged(monkeypatch):
    """A train step's gradients through a MoE block, every parameter's,
    are the same bits on the loop and on the (mocked) kernel route."""
    cfg = smoke_config("granite-moe-3b-a800m")
    blk = MoeBlock(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(4)
    for p in blk.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    pos = torch.arange(16).expand(2, 16)

    def grads():
        blk.zero_grad()
        y, aux = blk.forward_aux(x, positions=pos)
        (y.square().mean() + aux).backward()
        return [p.grad.clone() for p in blk.parameters()]

    want = grads()
    calls = _mock_card(monkeypatch)
    got = grads()
    assert len(calls) == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("g,s,e,k,want", [       # on an H100's 132 SMs
    (4, 256, 40, 8, 4),        # granite's decode: 256 blocks
    (256, 256, 40, 8, 32),     # granite's prefill: 2,048 blocks
    (1, 3, 40, 8, 3),          # fewer tokens than the tile
    (1, 256, 256, 8, 4),       # 256 experts
    (1, 256, 600, 8, 2)])      # shared memory holds two tokens a block
def test_tile_tokens(g, s, e, k, want):
    tile = K.tile_tokens(g, s, e, k, 132)
    assert tile == want
    assert K.smem_bytes(e, k, tile) <= K.SMEM_LIMIT


def test_tile_tokens_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        K.tile_tokens(1, 256, 800, 8, 132)


def test_source_constants_match_the_binding():
    text = (CSRC / "moe_dispatch.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    assert int(const["THREADS"]) == K.THREADS
    assert eval(const["SMEM_LIMIT"]) == K.SMEM_LIMIT
    assert "tile > 32" in text and K.MAX_TILE == 32
    assert "sizeof(int)) * (2 * k * E + tile * k + 2 * tile * E)" in text


@pytest.mark.parametrize("topv,topi,err", [
    (torch.zeros(1, 4, 2), torch.zeros(1, 4, 2, dtype=torch.int64),
     ValueError),                                  # a CPU tensor
    (torch.zeros(1, 4, 2, dtype=torch.bfloat16),
     torch.zeros(1, 4, 2, dtype=torch.int64), TypeError),
    (torch.zeros(1, 4, 2), torch.zeros(1, 4, 2, dtype=torch.int32),
     TypeError)])
def test_binding_refuses_before_building(topv, topi, err):
    with pytest.raises(err):
        K.moe_dispatch_cuda(topv, topi, 8, 4)
