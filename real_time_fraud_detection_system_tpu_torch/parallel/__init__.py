"""Attention over long histories (the single-device part; the sharded
forms wait for ROADMAP A7)."""
