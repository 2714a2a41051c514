"""Host-side I/O: PSRFITS archives, model files, .par and .tim files."""
