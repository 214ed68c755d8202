"""Sharding rules, the activation context and the collectives of mesh
serving."""
