"""The expert-parallel (MoE) example twin."""
