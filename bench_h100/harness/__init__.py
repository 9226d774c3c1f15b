"""The benchmark's machinery: cells by name, inputs, weights, drivers,
traces, the comparison with the plain reference and the result line."""
