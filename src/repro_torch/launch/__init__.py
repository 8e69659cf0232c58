"""Train-step builders and the training CLI of the port, with the
data-parallel mesh (mesh.py) and its partition rules (shard.py)."""
