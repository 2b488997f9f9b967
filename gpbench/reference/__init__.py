"""The benchmark's plain reference: GP regression in plain PyTorch, which
imports nothing of the program under test."""
