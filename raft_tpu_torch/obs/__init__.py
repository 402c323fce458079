"""Observability (port of ``raft_tpu/obs``): only the launch annotation the
engine's tick loop wraps around each replicate call is ported so far; the
rest of the planes come with ROADMAP A16."""
