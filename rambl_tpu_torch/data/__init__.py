"""Mock-community simulator (copy of rambl_tpu.data.simulate).
"""
