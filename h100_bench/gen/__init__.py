"""Audio generators of the benchmark: copies of the repository's recipes,
drawn from a seed, and the corpus builder that writes them as WAVs."""
