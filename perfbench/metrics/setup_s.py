"""Set-up: process start to the first timed step (imports, the weights
drawn on the card, the first job's prefill and the warm-up steps)."""


def read(rec):
    return rec["setup_s"]
