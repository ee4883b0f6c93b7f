"""Counting, coverage model, scoring engines, VCF output and pipeline."""
