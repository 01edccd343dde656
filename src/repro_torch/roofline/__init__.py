from .analysis import analyze_all, roofline_terms  # noqa: F401
