"""The yardstick: cells, inputs, the plain reference, rooflines, traces."""
