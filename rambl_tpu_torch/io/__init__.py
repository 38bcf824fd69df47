"""Host-side base codes (copy of the parts of rambl_tpu.io the port needs).
"""
