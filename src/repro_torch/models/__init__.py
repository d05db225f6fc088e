"""Models of the port: parameter containers and the functions that apply
them (layers, attention, the decoder stack, the serving API)."""
