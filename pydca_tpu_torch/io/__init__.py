"""Host I/O: FASTA ingestion and ranked-score writers."""
