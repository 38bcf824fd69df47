"""Seed index, taxonomy tables and column maps (copies of rambl_tpu.index).
"""
