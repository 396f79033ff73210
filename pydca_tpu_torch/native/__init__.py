"""Host code in C++, built at first use (the FASTA codec)."""
