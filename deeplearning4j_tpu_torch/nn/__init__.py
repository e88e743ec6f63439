"""Network runtimes (slice 1: ComputationGraph, inference only)."""
