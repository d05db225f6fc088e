"""Model configs: ``base`` holds the dataclass and the registry."""
