"""Host-side planner (numpy): data generators, LSH families, Eqs. 11-12
parameters, the partition into table groups and the serving plan."""
