"""User-facing API layer of the port: the intrusive tune/target protocol
(`tuneapi`, `report`, `state`: the child side of program mode, byte for
byte the JAX package's), session settings (`session`), the
constraint/covariate registry (`constraint`), `@ut.model` (`tuner`), the
EDA report extractors (`features`) and `tune_batch` (`batch`)."""
