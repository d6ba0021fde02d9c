"""Serving of the port's LMs: batched prefill and greedy decode."""
