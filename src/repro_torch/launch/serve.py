"""Batched serving launcher: prefill + continuous greedy decode (the port of
the JAX package's ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --batch 4 --prompt-len 64 --decode-steps 64 --mesh 1x1
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen3-4b \\
        --smoke --device cpu --backend gloo --mesh 2x1    # 2 CPU ranks

It runs on the CUDA card unless ``--device cpu`` asks for the CPU
(``--smoke --device cpu`` is the reduced config on the CPU).  Parameters are
drawn from a generator on the device seeded 0 (no weights are read).

``--dcim-select`` adds the serving-time macro-selection step: the launcher
synthesizes the multi-spec DCIM frontier through the online synthesis
service on the same device (one fused, cached pass over the scenario specs,
submitted as typed INTERACTIVE requests), co-designs it against the
deployed arch's GEMM inventory, and reports the macro the workload would be
served on.  ``--dcim-cache PATH`` points the service at a persistent
frontier store, making the second launch warm (zero engine executions);
``--dcim-profile PATH`` round-trips the preference-profile artifact through
:func:`repro_torch.serve.select.apply_profile`.

The ``--dcim-*`` flag cluster is one typed posture,
:class:`repro_torch.serve.config.ServeConfig`: ``--dcim-config PATH`` loads
it from a JSON artifact and every explicitly-passed flag overrides the file.

``--dcim-trace PATH`` turns on :mod:`repro_torch.obs` tracing for the
launch: the selection pass runs through a
:class:`repro_torch.service.ServiceFrontend` (so every request carries real
queued -> batched -> served timestamps), the prefill and every decode step
record their layer spans (``serve.prefill`` / ``serve.decode_step`` over
``attn``, ``moe.route``, ``moe.experts``, ``mamba`` and ``fake_quant``),
and a Chrome-trace JSON of both lands at PATH.  ``--dcim-kernel-profile PATH`` feeds a measured
``scripts/torch_profile_kernels.py --json`` artifact into the serving
roofline (``kernel_fraction`` derate).

Under ``torch.distributed.run`` the ranks join one process group with
``--backend`` and ``--mesh`` is a mesh of them (the reference's sharded
serving): the parameters are placed by the logical rules and gathered whole
per block as it runs, the prompt batch splits over the batch ranks (each
rank's decode state holds its own rows; a MoE layer whose token groups
would span them gathers the global batch, :mod:`repro_torch.models.moe`),
and rank 0 gathers the greedy tokens and prints the reference's lines,
then the group's backend (:func:`repro_torch.launch.mesh.group_line`).
``--dcim-select`` runs on rank 0 alone: like the reference's, it reports
the selection and changes nothing the ranks run.  A mesh wider than the
world shrinks by the reference's rule
(:func:`repro_torch.launch.mesh.make_host_mesh`).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, smoke_config
from ..models import get_model
from ..serve import make_decode_step, make_prefill
from ..serve.config import serve_config_from_args
from ..serve.step import greedy_argmax
from .mesh import (BACKENDS, group_line, init_distributed, is_main,
                   make_host_mesh, mesh_dims, parse_mesh)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA card; "
                         "'cpu' for the CPU)")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--backend", choices=BACKENDS, default="nccl",
                    help="process-group backend under "
                         "torch.distributed.run (gloo for several ranks "
                         "on one card or on the CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--dcim-config", default=None, metavar="PATH",
                    help="JSON ServeConfig artifact consolidating the "
                         "--dcim-* posture (schema "
                         "syndcim-serve-config/v1); explicit --dcim-* "
                         "flags override the file")
    ap.add_argument("--dcim-select", action="store_true",
                    help="select a DCIM macro for this workload from the "
                         "multi-spec synthesized frontier before serving")
    ap.add_argument("--dcim-macros", type=int, default=None,
                    help="macro-array size assumed for --dcim-select "
                         "(default 256)")
    ap.add_argument("--dcim-pref", default=None, metavar="W,E,A",
                    help="preference weights wallclock,energy,area for "
                         "--dcim-select (e.g. 0.2,0.6,0.2); default: pure "
                         "wallclock")
    ap.add_argument("--dcim-profile", default=None, metavar="PATH",
                    help="JSON preference-profile artifact persisted per "
                         "deployment config: read before --dcim-select "
                         "(profile weights for this arch override "
                         "--dcim-pref) and updated afterwards with the "
                         "weights the selection ran under")
    ap.add_argument("--dcim-cache", default=None, metavar="PATH",
                    help="persistent frontier-cache directory for the "
                         "synthesis service: the first --dcim-select launch "
                         "writes the synthesized scenario frontiers there, "
                         "every later launch serves them with zero engine "
                         "executions")
    ap.add_argument("--dcim-registry", default=None, metavar="PATH",
                    help="fleet-shared artifact-registry root (a directory "
                         "on shared storage): frontiers synthesized by ANY "
                         "host land there, so every other host's "
                         "--dcim-select launch is warm; claim files keep "
                         "concurrent cold launches from synthesizing the "
                         "same spec twice (see scripts/torch_warm_cache.py "
                         "to pre-fill it ahead of a deployment)")
    ap.add_argument("--dcim-trace", default=None, metavar="PATH",
                    help="enable request tracing and write a Chrome-trace "
                         "JSON (ui.perfetto.dev) of the launch: per-request "
                         "queued/batched/served spans, cache-tier probes, "
                         "engine phases, kernel dispatches, and the "
                         "prefill's and decode steps' layer spans")
    ap.add_argument("--dcim-trace-sample", type=float, default=None,
                    metavar="F", help="head sampling rate for --dcim-trace "
                                      "in (0, 1] (default 1.0)")
    ap.add_argument("--dcim-kernel-profile", default=None, metavar="PATH",
                    help="kernel-profile artifact from scripts/"
                         "torch_profile_kernels.py --json: its measured "
                         "pipeline efficiency derates the serving roofline "
                         "(kernel_fraction)")
    return ap


def _select(cfg, dcim, device: torch.device) -> None:
    """The ``--dcim-select`` step: selection through the synthesis service
    on ``device``, and its ``dcim:`` report lines."""
    from ..core.dse import gemm_inventory
    from ..serve.select import apply_profile, select_macros
    from ..service import (ArtifactRegistry, FrontierCache, ServiceFrontend,
                           SynthesisService)

    kernel_fraction = 1.0
    if dcim.kernel_profile is not None:
        from ..kernels.profile import fraction_from_profile_artifact
        kernel_fraction = fraction_from_profile_artifact(dcim.kernel_profile)
        print(f"dcim: kernel profile {dcim.kernel_profile}: serving "
              f"roofline derated by measured pipeline efficiency "
              f"{kernel_fraction:.3f}")
    registry = (None if dcim.registry is None
                else ArtifactRegistry(dcim.registry))
    service = SynthesisService(
        cache=FrontierCache(store_dir=dcim.cache, registry=registry),
        device=device)
    serve_via = service
    frontend = None
    if dcim.trace is not None:
        # Route the selection pass through the admission frontend so every
        # traced request carries real queued -> batched -> served timestamps
        # (the span boundaries the trace shows).
        frontend = ServiceFrontend(service)
        serve_via = frontend
    try:
        sel, _ = apply_profile(
            dcim.profile,
            lambda profile: select_macros({cfg.name: gemm_inventory(cfg)},
                                          n_macros=dcim.macros,
                                          preference=dcim.pref,
                                          profile=profile,
                                          service=serve_via,
                                          kernel_fraction=kernel_fraction))
    finally:
        if frontend is not None:
            frontend.close()
    if dcim.profile is not None:
        print(f"dcim: preference profile updated: {dcim.profile}")
    cs, ss = service.cache.stats, service.stats
    print(f"dcim: synthesis service "
          f"{'warm' if ss.misses == 0 else 'cold'} "
          f"(hits={cs.hits + cs.disk_hits + cs.shared_hits} "
          f"misses={ss.misses} fused_passes={ss.fused_passes}"
          + (f", cache={dcim.cache}" if dcim.cache else "")
          + ")")
    if dcim.registry is not None:
        rt = service.cache.registry.telemetry()
        print(f"dcim: shared registry {dcim.registry}: "
              f"{rt['entries']} entries, "
              f"hits={rt['hits']} misses={rt['misses']} "
              f"fills={rt['fills']} "
              f"claims={rt['claims_acquired']}"
              f"/{ss.claim_waits} waited"
              f"/{ss.claim_hits} served-by-peer")
    wi = sel.codesign.workloads.index(cfg.name)
    di = sel.assignment[cfg.name]
    est = sel.serving_for(cfg.name)
    applied = sel.preferences_applied[cfg.name]
    print(f"dcim: {len(sel.pool)} frontier candidates from scenarios "
          f"{', '.join(sel.scenarios)}"
          + (f", preference={applied}" if applied else ""))
    print(f"dcim: selected {sel.label_for(cfg.name)} for {cfg.name} "
          f"({dcim.macros} macros, "
          f"eff_tops={sel.codesign.effective_tops[wi, di]:.3f}, "
          f"util={sel.codesign.avg_util[wi, di]:.3f})")
    print(f"dcim: serving roofline {est.tokens_per_s:.1f} tok/s "
          f"({est.bottleneck}-bound: macro {est.t_macro_s * 1e3:.3f} ms "
          f"vs hbm {est.t_hbm_s * 1e3:.3f} ms per "
          f"{est.tokens}-token step)")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    device = init_distributed(args.backend, args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcim = serve_config_from_args(args)
    if dcim.trace is not None:
        from .. import obs
        obs.configure(enabled=True, sample=dcim.trace_sample)
    main_rank = is_main()
    if dcim.select and main_rank:
        _select(cfg, dcim, device)
    api = get_model(cfg)
    dims, axes = parse_mesh(args.mesh)
    mesh = make_host_mesh(dims, axes, device_type=device.type)
    ranks = None if isinstance(mesh, dict) else mesh
    name = device_name(device)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    if ranks is None:
        model = api.init_params(gen, device=device)
    else:
        from ..models import model_class
        from ..parallel.sharding import rules_for_mesh
        from ..parallel.zero import shard_model
        rules = rules_for_mesh(ranks, cfg.sharding_overrides)
        model = shard_model(model_class(cfg)(cfg, device="meta"), ranks,
                            rules, generator=gen, device=device)
    _sync(device)
    t_init = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (args.batch, args.prompt_len)),
                              device=device)
    frontend = None
    if cfg.frontend is not None:
        frontend = torch.as_tensor(rng.normal(size=(
            args.batch, cfg.frontend.n_tokens, cfg.frontend.d_frontend)),
            dtype=torch.float32, device=device)
    over = contextlib.nullcontext()
    if ranks is not None:           # this rank's rows of the prompt batch
        from ..parallel.zero import (batch_axes, data_parallel, dp_rank,
                                     dp_size)
        baxes = batch_axes(ranks, rules)
        over = data_parallel(ranks, baxes)
        n_dp, r_dp = dp_size(ranks, baxes), dp_rank(ranks, baxes)
        if args.batch % n_dp:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"{n_dp} batch ranks")
        per = args.batch // n_dp
        prompts = prompts[r_dp * per:(r_dp + 1) * per]
        if frontend is not None:
            frontend = frontend[r_dp * per:(r_dp + 1) * per]

    cache_len = args.prompt_len + args.decode_steps
    prefill = make_prefill(api, cache_len)
    decode = make_decode_step(api)

    with over:
        t0 = time.perf_counter()
        logits, state = prefill(model, prompts, frontend)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        tok = greedy_argmax(logits)
        out = [tok]
        t1 = time.perf_counter()
        for _ in range(args.decode_steps - 1):
            logits, state = decode(model, state, tok)
            tok = greedy_argmax(logits)
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t1
    tokens = torch.cat(out, dim=1)
    if ranks is not None:
        from ..parallel.zero import gather_rows
        tokens = gather_rows(tokens, ranks, baxes)
    group = group_line()
    if not main_rank:
        dist.destroy_process_group()
        return

    n_tok = args.batch * args.decode_steps
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} mesh={mesh_dims(mesh)} device={device}")
    print(f"init   : {n_params} parameters in {t_init:.2f}s on {name}")
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{t_prefill:.2f}s on {name}")
    print(f"decode : {n_tok} tokens in {t_decode:.2f}s "
          f"({n_tok / max(t_decode, 1e-9):.1f} tok/s) on {name}")
    print("sample:", tokens[0, :16].cpu().numpy())
    if group is not None:
        print(group)

    if dcim.trace is not None:
        from ..obs import tracer
        from ..obs.export import write_chrome_trace
        n = write_chrome_trace(tracer.drain(), dcim.trace)
        print(f"dcim: trace: {n} span events -> {dcim.trace} "
              f"(load at ui.perfetto.dev or chrome://tracing)")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
