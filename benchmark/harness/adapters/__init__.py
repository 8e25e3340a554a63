"""The models a configuration names, one module a `model`
(`configs/<config>.json`), found by that name: each holds an `Adapter`."""
