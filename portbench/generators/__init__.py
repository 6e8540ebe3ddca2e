"""History generators, one module each, found by the name a
configuration's ``history.generator`` gives: ``make(params, seed) ->
History``. They are frozen copies of the port's own loaders and
generators, so a later change to the port cannot move the traffic."""
