"""The benchmark's data sets, one module each, found by a configuration's
`data.kind`: `load(spec, seed) -> dict` of float32 arrays, made from the
spec (and, where it draws, from `seed`) with nothing of the program."""
