from .registry import load_dataset

__all__ = ["load_dataset"]
