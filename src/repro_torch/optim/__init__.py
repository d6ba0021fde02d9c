"""The port's optimizer: AdamW with the reference's schedule and global
clipping (`optimizer`), and gradient compression with error feedback
(`compression`)."""
