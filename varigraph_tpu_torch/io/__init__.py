"""FASTQ streaming and gz output."""
