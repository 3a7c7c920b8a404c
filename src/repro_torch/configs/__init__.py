"""Model and run configurations: the reference's dataclasses
(`base`), its architecture registry and the ten architectures' published
configs (`registry`, one module each), copied from `repro.configs`."""
