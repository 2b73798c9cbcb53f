"""Research extras (reference `seesaw/research/`): experimental models that
sit outside the production loop registry; the port's counterparts of
`seesaw_tpu/research/`."""
