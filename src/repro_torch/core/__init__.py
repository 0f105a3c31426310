"""Spiking dataflow core: packing, LIF, the plain FTP reference and the
spiking layers."""
