"""Model inputs of the port (the counterpart of ``repro.data``): the VLM
and audio frontend stub."""
