"""The model zoo of the port: configs, layers, MoE, the layerwise and
stacked backbones, sampling and parameter accounting (the counterpart of
``repro.models``)."""
