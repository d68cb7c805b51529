"""The plain reference: NeRF and SiNeRF in float32 torch with the
occupancy-grid sampler, the compositing and Adam, importing nothing of the
port."""
