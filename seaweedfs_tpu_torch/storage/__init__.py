"""Storage formats and the erasure-coding file pipeline of the port."""
