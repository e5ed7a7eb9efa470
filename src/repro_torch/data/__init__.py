"""Model inputs of the port (the counterpart of ``repro.data``): the
synthetic token stream and the VLM / audio frontend stub."""
