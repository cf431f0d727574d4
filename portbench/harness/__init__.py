"""The harness: finds a cell's configuration, traffic mix, limits and
per-layer readers by name, drives the port's batched entry in a closed
loop, times it, traces it on request and judges its answers against the
plain reference (:mod:`portbench.reference`)."""
