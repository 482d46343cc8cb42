"""Notification: publish filer meta events to pluggable queues.

Behavioral model: weed/notification/configuration.go — config-driven
sinks (kafka/sqs/pubsub in the reference); here: log file, the message
broker, and an in-memory collector for tests.

The port's copy of ``seaweedfs_tpu/notification/__init__.py``.
"""

from .publisher import (  # noqa: F401
    BrokerQueue,
    LogQueue,
    MemoryQueue,
    NotificationPublisher,
)
