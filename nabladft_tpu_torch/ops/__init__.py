"""Graph, radial and aggregation ops, and the fused PaiNN message kernels."""
