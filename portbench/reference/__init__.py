"""The plain reference: PyTorch in float32, no kernel, no cache, no batching
across samples, and nothing of the program under test."""
