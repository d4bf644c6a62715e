from .profiling import Timer, force_completion, trace

__all__ = ["Timer", "force_completion", "trace"]
