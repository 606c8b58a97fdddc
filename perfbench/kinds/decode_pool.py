"""The traffic kind ``decode_pool``: a closed-loop decode pool, the
generator and serving loop of every traffic file of this kind.

A traffic file gives ``batch`` sequences per job, ``prompt_len`` prompt
tokens (ids uniform over the vocabulary, drawn on the device from the seed
and the job's index), ``output_len`` greedy tokens and ``cache_len``.  A
job is one prefill of the whole batch, then decode steps until every
sequence has its ``output_len`` tokens; the next job starts when the last
ends (a closed loop).  The program is driven only through its serving
entry points: ``serve.step.make_prefill`` and ``make_decode_step`` over
``models.get_model(cfg)``, with greedy argmax.

Every step copies its tokens to the host, as a server streams them to its
users, so each step ends with the device synchronised.  Each event keeps
the host's clock at its call, at the call's return and once its tokens are
on the host.  The run finds this module by the traffic file's ``kind``
(:func:`perfbench.lib.manifest.load_kind`).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

from ..lib.seeds import sub_seed


@dataclass
class Job:
    index: int
    prompts: torch.Tensor            # (B, P) on the host
    state: dict | None
    tok: torch.Tensor | None         # (B, 1) on the device
    out: list = field(default_factory=list)   # (B,) host tensors
    last_t: int = 0                  # host ns of its latest tokens
    pos: int = 0                     # positions cached

    @property
    def n_out(self) -> int:
        return len(self.out)


def clone_state(state: dict) -> dict:
    return {k: v.clone() for k, v in state.items()}


class Pool:
    """The serving loop of one cell (module doc).  ``fault`` breaks the
    timed path on purpose, for the tests of the comparison:
    ``state_unchanged`` (a decode step that returns the state it was
    given), ``half_batch`` (the second half of the batch left out: its
    logits zero) or ``token_altered`` (the fourth token of every request
    moved by one id where argmax produces it)."""

    def __init__(self, api, model, traffic: dict, vocab: int, seed: int,
                 device, fault: str | None = None):
        from repro_torch.serve.step import (greedy_argmax, make_decode_step,
                                            make_prefill)
        self.model, self.device, self.seed = model, device, seed
        self.vocab, self.fault = vocab, fault
        self.batch = int(traffic["batch"])
        self.prompt_len = int(traffic["prompt_len"])
        self.output_len = int(traffic["output_len"])
        cache_len = int(traffic["cache_len"])
        if self.prompt_len + self.output_len > cache_len + 1:
            raise ValueError("prompt_len + output_len - 1 exceeds cache_len")
        self._prefill = make_prefill(api, cache_len)
        self._decode = make_decode_step(api)
        self._argmax = greedy_argmax
        self.jobs: list[Job] = []
        self.events: list[dict] = []

    # ------------------------------------------------------------ traffic
    def prompts(self, index: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.seed, "prompts", index))
        return torch.randint(0, self.vocab, (self.batch, self.prompt_len),
                             generator=gen, device=self.device)

    # ------------------------------------------------------------ serving
    def _emit(self, job: Job, tok: torch.Tensor) -> int:
        job.tok = tok
        job.out.append(tok.view(-1).to("cpu"))    # synchronises
        t = time.perf_counter_ns()
        job.last_t = t
        return t

    def _label(self, name: str, spans: bool):
        return torch.profiler.record_function(name) if spans else \
            nullcontext()

    def start_job(self, spans: bool = False) -> dict:
        """Prefill the next job (the last one's state freed first)."""
        if self.jobs:
            self.jobs[-1].state = None
        index = len(self.jobs)
        prompts = self.prompts(index)
        t0 = time.perf_counter_ns()
        with self._label("prefill", spans):
            logits, state = self._prefill(self.model, prompts)
        t_ret = time.perf_counter_ns()
        with self._label("argmax", spans):
            tok = self._argmax(logits)
        del logits
        b, p = prompts.shape
        job = Job(index=index, prompts=prompts.to("cpu"), state=state,
                  tok=None, pos=p)
        self.jobs.append(job)
        with self._label("token_copy", spans):
            t_end = self._emit(job, tok)
        ev = {"kind": "prefill", "job": index, "t0": t0, "t_ret": t_ret,
              "t_end": t_end, "tokens": b}
        self.events.append(ev)
        return ev

    def step(self, spans: bool = False) -> dict:
        """One decode step of the current job (or the next job's prefill
        once the current one has all its tokens)."""
        job = self.jobs[-1]
        if job.n_out >= self.output_len:
            return self.start_job(spans)
        prev = job.last_t
        filled = job.pos + 1
        b = job.prompts.shape[0]
        t0 = time.perf_counter_ns()
        with self._label("decode_call", spans):
            if self.fault == "state_unchanged":
                logits, _ = self._decode(self.model, clone_state(job.state),
                                         job.tok)
            else:
                logits, job.state = self._decode(self.model, job.state,
                                                 job.tok)
        t_ret = time.perf_counter_ns()
        with self._label("argmax", spans):
            if self.fault == "half_batch":
                logits[b // 2:] = 0
            tok = self._argmax(logits)
            if self.fault == "token_altered" and job.n_out == 3:
                tok = (tok + 1) % self.vocab
        del logits
        job.pos += 1
        with self._label("token_copy", spans):
            t_end = self._emit(job, tok)
        ev = {"kind": "decode", "job": job.index, "t0": t0, "t_ret": t_ret,
              "t_end": t_end, "tokens": b, "gap_ns": t_end - prev,
              "filled": filled}
        self.events.append(ev)
        return ev

    def free(self) -> None:
        for job in self.jobs:
            job.state = None
            job.tok = None

    def served(self) -> list:
        """``[(prompts (B, P), served (B, n))]`` per job, on the host."""
        return [(j.prompts, torch.stack(j.out, dim=1)) for j in self.jobs]
