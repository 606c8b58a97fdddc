"""Plain versions of the chunked linear-recurrence (SSM) scan.

Recurrence (diagonal):  h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0
Returns every state h_0..h_{T-1} plus the final carry.

Three plain versions: as in the JAX package, a sequential loop (ground
truth; each step a multiply then an add, both rounded) and an associative
composition (A, B) o (A', B') = (A'A, A'B + B') run as a log-depth
doubling, since torch has no ``associative_scan``; and the chunked scan
the CUDA kernel computes (:func:`ssm_scan_chunked_ref`), whose split
:func:`ssm_chunks` fixes from the shape alone.
"""

from __future__ import annotations

import torch

#: Columns x chunks the chunked scan aims to run in parallel: each
#: (chunk, column) pair is one thread of the card's first and last pass.
SSM_PARALLEL_COLUMNS = 16_384

#: Rows a chunk should have at least (even splitting may leave one fewer):
#: shorter chunks make the carry chain of the last pass longer than the
#: parallelism they add saves.  With these two, (1024, 256), (4096, 256)
#: and (1000, 300) take S = 32, 64 and 32, the fastest of S = 4..128 on an
#: H100 (``probes/ssm_split.py``).
SSM_MIN_CHUNK_ROWS = 32


def ssm_chunks(t: int, d: int) -> tuple[int, int]:
    """(S, L): the chunked scan splits T rows into S chunks of L rows (the
    last one ragged).  A function of (T, D) alone, so every tile, depth
    and card computes the same bits; S = 1 (one sequential pass) once D
    columns fill the card by themselves."""
    want = -(-SSM_PARALLEL_COLUMNS // max(d, 1))
    s = max(1, min(-(-t // SSM_MIN_CHUNK_ROWS), want))
    rows = -(-t // s) if t else 0
    return (-(-t // rows) if rows else 1), rows


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (T, D); h0: (D,) -> (states (T, D), final (D,))."""
    states = torch.empty_like(a)
    h = h0
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        states[t] = h
    return states, h.clone()


def ssm_scan_assoc_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract via the associative composition: Hillis-Steele
    doubling over [(1, h0), (a_0, b_0), ...], log2(T + 1) passes."""
    aa = torch.cat([torch.ones_like(h0)[None], a], dim=0)
    bb = torch.cat([h0[None], b], dim=0)
    span = 1
    while span < aa.shape[0]:
        # element t composes with element t - span: B_t += A_t * B_{t-span}
        bb = torch.cat([bb[:span], aa[span:] * bb[:-span] + bb[span:]], 0)
        aa = torch.cat([aa[:span], aa[span:] * aa[:-span]], 0)
        span *= 2
    states = bb[1:]
    return states, states[-1].clone() if len(states) else h0.clone()


def ssm_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                         chunks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan, as the CUDA kernel runs it: T cut into chunks of
    L = ceil(T / chunks) rows, then three passes in a fixed order, each
    step one rounded multiply and one rounded add.

      1. each chunk but the last, from a zero state: its decay product
         A = a_0 a_1 ... (left to right) and its end state B;
      2. the carries in sequence: h_in[0] = h0, h_in[c+1] = A_c h_in[c] +
         B_c;
      3. each chunk re-scanned from h_in[c], writing its states.

    With one chunk this is :func:`ssm_scan_ref` step for step."""
    t, d = a.shape
    if t == 0:
        return torch.empty_like(a), h0.clone()
    rows = -(-t // chunks)
    s = -(-t // rows)
    pad = s * rows - t
    ac = torch.cat([a, a.new_ones((pad, d))]).view(s, rows, d)
    bc = torch.cat([b, b.new_zeros((pad, d))]).view(s, rows, d)
    prod = a.new_ones((s - 1, d))
    end = a.new_zeros((s - 1, d))
    for r in range(rows):
        prod = ac[:-1, r] * prod
        end = ac[:-1, r] * end + bc[:-1, r]
    h = h0
    carries = [h0]
    for c in range(s - 1):
        h = prod[c] * h + end[c]
        carries.append(h)
    h = torch.stack(carries)
    states = torch.empty_like(ac)
    for r in range(rows):
        h = ac[:, r] * h + bc[:, r]
        states[:, r] = h
    states = states.reshape(s * rows, d)[:t]
    return states, states[-1].clone()
