from .pipeline import (DataState, SyntheticBigramLM, SyntheticUniformLM,
                       make_pipeline)

__all__ = ["DataState", "SyntheticBigramLM", "SyntheticUniformLM",
           "make_pipeline"]
