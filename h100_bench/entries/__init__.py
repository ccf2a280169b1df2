"""Entries a traffic mix can name (`traffic/<mix>.json: "entry"`): the
port's call a step makes, the sampling units of a step, which outputs are
kept, and how they are held against the reference."""
