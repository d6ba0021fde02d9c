"""The port's data: deterministic synthetic or file-backed token streams
(`pipeline`)."""
