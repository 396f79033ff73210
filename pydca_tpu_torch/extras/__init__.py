from .a2m2aln import convert_a2m, run_a2m2aln  # noqa: F401
