// Parity oracle: run OpenCV 4.x cv::CascadeClassifier::detectMultiScale on an
// image and print detections, mirroring the reference detection sample
// (reference: tools/detection/Cpp/main.cpp:42-49). Used by the test suite to
// cross-validate the JAX detector and to prove our cascade.xml output loads
// in the independent OpenCV runtime (the reference's own strongest oracle,
// see its test_integration.cpp).
//
// usage: detect_oracle <cascade.xml> <image> [scaleFactor] [minNeighbors] [minW minH]
#include <cstdio>
#include <cstdlib>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/objdetect.hpp>

int main(int argc, char** argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s cascade.xml image [scaleFactor] [minNeighbors] [minW minH]\n", argv[0]);
        return 2;
    }
    double scaleFactor = argc > 3 ? atof(argv[3]) : 1.1;
    int minNeighbors = argc > 4 ? atoi(argv[4]) : 3;
    cv::Size minSize;
    if (argc > 6) minSize = cv::Size(atoi(argv[5]), atoi(argv[6]));

    cv::CascadeClassifier cc;
    if (!cc.load(argv[1])) {
        fprintf(stderr, "LOAD_FAILED\n");
        return 1;
    }
    printf("LOADED\n");

    cv::Mat img = cv::imread(argv[2], cv::IMREAD_GRAYSCALE);
    if (img.empty()) {
        fprintf(stderr, "IMG_FAILED\n");
        return 1;
    }
    std::vector<cv::Rect> objs;
    cc.detectMultiScale(img, objs, scaleFactor, minNeighbors, 0, minSize);
    for (const auto& r : objs) printf("%d %d %d %d\n", r.x, r.y, r.width, r.height);
    return 0;
}
