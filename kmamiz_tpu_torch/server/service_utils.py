"""Label-map refresh.

Counterpart of kmamiz_tpu/server/service_utils.py (KMamiz
src/services/ServiceUtils.ts), reduced to `update_label`: user label
rules are applied first, unknown endpoints are guessed against them, the
remaining endpoints get speculated labels, and the labeled dependency
view is rebuilt. The labeled historical and aggregated reads wait for the
port's store.
"""
from __future__ import annotations

from kmamiz_tpu_torch.analytics.endpoint_utils import (
    create_endpoint_label_mapping,
    guess_and_merge_endpoints,
)
from kmamiz_tpu_torch.server.cache import DataCache


class ServiceUtils:
    def __init__(self, cache: DataCache) -> None:
        self._cache = cache

    def update_label(self) -> None:
        label_mapping = self._cache.get("LabelMapping")
        data_type = self._cache.get("EndpointDataType")
        user_defined_label = self._cache.get("UserDefinedLabel")
        dependencies = self._cache.get("EndpointDependencies")
        labeled_dependencies = self._cache.get("LabeledEndpointDependencies")

        user_defined = user_defined_label.get_data()
        data_types = data_type.get_data()
        # the reference's `if (dataTypeData)` is always truthy (getData
        # returns `|| []`): the rebuild runs even with zero datatypes, so
        # user-defined rules alone can populate the mapping
        if data_types is not None:
            preprocessed: dict = {}
            if user_defined:
                for rule in user_defined.get("labels", []):
                    if rule.get("block"):
                        continue
                    for sample in rule.get("samples", []):
                        preprocessed[sample] = rule["label"]
            preprocessed = guess_and_merge_endpoints(
                [d.to_json()["uniqueEndpointName"] for d in data_types],
                preprocessed,
            )

            label_map = create_endpoint_label_mapping(
                [
                    d
                    for d in data_types
                    if d.to_json()["uniqueEndpointName"] not in preprocessed
                ]
            )
            label_map.update(preprocessed)

            label_mapping.set_data(
                label_map, user_defined_label.get_data(), dependencies.get_data()
            )

        dep = dependencies.get_data()
        if dep:
            labeled_dependencies.set_data(dep)
