"""The fused FM receive chain over L1 blocks."""
