"""The benchmark's general code: inputs, load, trace, metrics arithmetic,
the reference and the judge. Nothing here names a cell."""
