"""Shared by the families' counts."""

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
