"""The training and evaluation entries a traffic mix drives, one module a
`kind` (`traffic/<mix>.json`), found by that name."""
