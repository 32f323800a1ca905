from .pipeline import Pipeline
