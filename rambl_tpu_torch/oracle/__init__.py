"""Pure-NumPy oracle: the port's copy of the executable specification in
`rambl_tpu/oracle/` that the kernels and the align step are held against."""
