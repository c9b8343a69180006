"""The pipeline-parallel example twin."""
