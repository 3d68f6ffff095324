from . import benchmark, checkpoint, morton, random_data, runtime

__all__ = ["benchmark", "checkpoint", "morton", "random_data", "runtime"]
