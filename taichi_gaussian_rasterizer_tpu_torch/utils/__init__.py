# random_data is not imported here: it imports ops, whose modules import
# tracing from this package; `from ..utils import random_data` loads it
from . import checkpoint, morton, runtime, tracing

__all__ = ["checkpoint", "morton", "random_data", "runtime", "tracing"]
