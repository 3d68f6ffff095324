from . import random_data

__all__ = ["random_data"]
