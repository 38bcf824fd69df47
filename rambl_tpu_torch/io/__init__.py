"""Host-side sequence I/O (copies of the parts of rambl_tpu.io the port needs).
"""
