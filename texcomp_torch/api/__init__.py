"""Public API: Compressor interface, DxtcCompressor, CompressedImage."""
