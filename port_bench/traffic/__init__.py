"""Traffic mixes: ``<name>.json`` holds a mix's parameters and names its generator,
``<generator>.py`` in this folder, which turns the parameters and a seed into the
cell's requests or training batches."""
