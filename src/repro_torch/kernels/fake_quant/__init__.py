from .kernel import LAUNCHES, fake_quant_cuda, launch_plan

__all__ = ["LAUNCHES", "fake_quant_cuda", "launch_plan"]
