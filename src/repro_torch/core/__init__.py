"""Host-side core (numpy): data generators, LSH families, Eqs. 11-12
parameters, the partition into table groups and the serving plan, the
paper-faithful host search with I/O accounting (``WLSHIndex.search``),
and the C2LSH, E2LSH and SL/S2-ALSH baselines."""
