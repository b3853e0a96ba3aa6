"""Config parsing, meters, logging and event records of the training CLI."""
