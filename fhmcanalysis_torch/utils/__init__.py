from .profiling import add, counters, span, spanned, trace

__all__ = ["add", "counters", "span", "spanned", "trace"]
