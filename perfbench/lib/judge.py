"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
requests it served (drawn from the seed; the family's ``sample`` decides
its shape) is run through the family's plain float32 reference,
teacher-forced on its prompts and served tokens, with the weights drawn
again from the seed.  At every position whose next token was served, the
number compared is the gap by which the served token's logit lies below
the reference's best; ``widest_gap`` is the widest over the sample.

The control is the same reference computed in the next precision below
the configuration's compute dtype (``reference.common.BELOW``: float8
e4m3 below bfloat16): at each position of the same prompts and tokens,
the gap of the token the control puts first.  Its numbers go through the
same :func:`verdict` as the program's, which has to find them not
correct.

Each cell's ``checks/<cell>.json`` names the numbers it compares, each
with its limit: ``widest_gap``, ``mean_gap`` (the mean over the
positions) or ``seq_widest_median`` (the median over the sequences of
each one's widest gap, which a wrong token in every request moves);
``tokens_out_of_vocab`` is always compared, with the limit 0.
"""

from __future__ import annotations

import torch

from ..reference.common import BELOW, exact, no_tf32
from .seeds import sub_seed


def pick(served: list, output_len: int) -> int:
    """The job to compare: the latest that finished, else the one that
    ran last (every sequence of a job has as many tokens)."""
    done = [i for i, (_, out) in enumerate(served)
            if out.shape[1] >= output_len]
    return done[-1] if done else len(served) - 1


def _gaps(h: torch.Tensor, u: torch.Tensor, nxt: torch.Tensor, rnd,
          chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Per position (rows of ``h``): the best logit less the logit of
    ``nxt``, and the token these logits put first."""
    gaps, tops = [], []
    for i in range(0, h.shape[0], chunk):
        lg = rnd(h[i:i + chunk] @ u.T)
        best = lg.max(dim=-1)
        gaps.append(best.values
                    - lg.gather(1, nxt[i:i + chunk, None])[:, 0])
        tops.append(best.indices)
    return torch.cat(gaps), torch.cat(tops)


def _stats(gap: torch.Tensor, sequences: int) -> dict:
    """The numbers read off the gaps of one run (``sequences`` rows of
    positions)."""
    by_seq = gap.reshape(sequences, -1)
    return {"widest_gap": float(gap.max()), "mean_gap": float(gap.mean()),
            "p99_gap": float(torch.quantile(gap.float().cpu(), 0.99)),
            "seq_widest_median": float(by_seq.amax(dim=1).median()),
            "mismatch_share": float((gap > 0).float().mean())}


def verdict(readings: dict, check: dict) -> tuple[dict, bool]:
    """``({name: (value, limit)}, correct)``: each number that the cell's
    check compares, and ``tokens_out_of_vocab`` (limit 0), beside its
    limit; correct where none is over its limit."""
    compared = {name: (readings[name], float(c["limit"]))
                for name, c in check["compare"].items()}
    compared["tokens_out_of_vocab"] = (readings["tokens_out_of_vocab"], 0)
    return compared, all(v <= limit for v, limit in compared.values())


def compare(family, cfg: dict, check: dict, traffic: dict, served: list,
            weights, seed: int, device, control: bool = False) -> dict:
    """The numbers read off the gaps of the program's served tokens over
    the sample (``_stats``), each sequence's widest and mean gap, and with
    ``control`` the control's numbers on the same tokens (its tokens are
    the reference's columns, so none is out of the vocabulary).
    ``weights()`` draws the weights again."""
    no_tf32()
    job = pick(served, int(traffic["output_len"]))
    prompts, out = served[job]
    batch, p = prompts.shape
    gen = torch.Generator().manual_seed(sub_seed(seed, "sample", job))
    rows = family.sample(cfg, check, batch, p, gen)
    vocab = cfg["port"]["vocab"]
    tokens = torch.cat([prompts[rows], out[rows]], dim=1)
    bad = (tokens < 0) | (tokens >= vocab)
    tokens = tokens.clamp(0, vocab - 1).to(device)
    nxt = tokens[:, p:].reshape(-1)
    w = weights()
    with torch.no_grad():
        u = family.unembed(cfg, w)
        d = u.shape[-1]
        res = {"job": job, "sequences": len(rows), "positions": nxt.numel()}
        if control:
            low = BELOW[cfg["port"]["compute_dtype"]]
            hc = family.hidden(cfg, w, tokens, p, batch, low).reshape(-1, d)
            _, ctrl = _gaps(hc, low(u), nxt, low)
            del hc
        h = family.hidden(cfg, w, tokens, p, batch, exact).reshape(-1, d)
        gap, _ = _gaps(h, u, nxt, exact)
        gap[bad[:, p:].reshape(-1).to(device)] = torch.inf
        by_seq = gap.reshape(len(rows), -1)
        res.update(_stats(gap, len(rows)))
        res["per_sequence"] = {"widest_gap": by_seq.amax(dim=1).tolist(),
                               "mean_gap": by_seq.mean(dim=1).tolist()}
        if control:
            cgap, _ = _gaps(h, u, ctrl, exact)
            res["control"] = dict(_stats(cgap, len(rows)),
                                  tokens_out_of_vocab=0)
    res["tokens_out_of_vocab"] = sum(int(((o < 0) | (o >= vocab)).sum())
                                     for _, o in served)
    return res
