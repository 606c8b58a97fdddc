"""The host's time in the fake-quant (the `fake_quant` spans, which nest
inside the other layers' spans and count there too), summed per traced
decode step, mean over the steps."""

from perfbench.lib.program_spans import host_ms


def read(rec):
    return host_ms(rec, "fake_quant")
