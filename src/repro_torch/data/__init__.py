from .pipeline import DataState, SyntheticLMData

__all__ = ["SyntheticLMData", "DataState"]
