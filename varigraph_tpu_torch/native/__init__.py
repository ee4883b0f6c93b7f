"""Native FASTQ reader, built with g++ at first use."""
