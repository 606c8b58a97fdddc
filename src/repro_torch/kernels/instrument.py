"""Kernel-dispatch observability: one span + counters per kernel dispatch.

Every public kernel entry point (``dcim_matmul``/``dcim_matmul_int``,
``ssm_scan``, ``csa_tree_sum``) routes its call through
:func:`dispatch_span`, which records, under the JAX package's names,

  * a ``kernel.<name>`` span (child of whatever span is current) tagged
    with the shape, the tile config chosen, the route taken (``pipelined``
    vs ``grid``, ``tiled`` vs ``rows``), where the tile came from
    (autotune ``memo``/``registry``/``default``, an ``explicit`` config,
    or the ``default`` posture) and the device the call ran on;
  * always-on dispatch counters in the global metrics registry
    (``kernel/<name>/dispatch``, ``.../route/<route>``,
    ``.../tile_source/<source>``).

A CPU tensor takes the same route and tile as a CUDA one and runs the
route's plain version, so the counters name the route a call took on
either device; the kernel launches themselves are counted by the
wrappers' ``launches`` attributes.
"""

from __future__ import annotations

import contextlib

from ..obs import tracer
from ..obs.metrics import get_registry


@contextlib.contextmanager
def dispatch_span(kernel: str, shape: tuple[int, ...], tile, source: str,
                  route: str, device):
    """Wrap one kernel dispatch: dispatch counters plus (when a trace is
    live) a ``kernel.<name>`` span.  ``tile`` is the resolved TileConfig;
    ``source`` is the tile attribution; ``device`` the operands' device."""
    reg = get_registry()
    reg.counter(f"kernel/{kernel}/dispatch").inc()
    reg.counter(f"kernel/{kernel}/route/{route}").inc()
    reg.counter(f"kernel/{kernel}/tile_source/{source}").inc()
    span = tracer.span(f"kernel.{kernel}", tags={
        "shape": "x".join(str(int(d)) for d in shape),
        "route": route, "tile_source": source, "device": str(device)})
    if span:
        span.set_tag("tile", tile.as_dict())
    with span:
        yield span
