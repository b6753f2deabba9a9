"""The dense LM stack of the port: config, layers, attention, blocks and
the model's prefill and decode entry points."""
