"""End-to-end measurement pipelines."""
