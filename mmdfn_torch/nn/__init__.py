"""Layers: mask-gated bi-GRU encoders, the GCNII stack and the plain GCN
layers, the edge attention, the fusion heads."""
