"""Public API: the Compressor interface, DxtcCompressor, EtcCompressor,
transcode_dxt1_to_etc1 and CompressedImage."""
