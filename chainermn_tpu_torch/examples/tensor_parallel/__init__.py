"""The tensor-parallel example twin."""
