from .kernel import LAUNCHES, moe_dispatch_cuda, tile_tokens

__all__ = ["LAUNCHES", "moe_dispatch_cuda", "tile_tokens"]
