"""The general generators a traffic mix names by its ``driver`` key: each
module's ``Driver`` makes a run's inputs from the seed, drives the
program one pass at a time, and holds the answers of the last pass to the
plain reference."""
