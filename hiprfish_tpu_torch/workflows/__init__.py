"""Workflow driver: the in-process replacement for the Snakemake rules."""
