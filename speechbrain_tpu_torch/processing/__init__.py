"""Signal processing: feature extraction and input normalization."""
