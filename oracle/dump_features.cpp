// Golden-oracle tool: link the reference TrainCascadeLib and dump the
// generated feature catalogs (geometry + evaluator responses on a fixed
// random image) to stdout for cross-validation of the JAX rebuild.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>

#include <opencv2/core.hpp>

#include "haarfeatures.h"
#include "lbpfeatures.h"
#include "HOGfeatures.h"

struct HaarDumper : CvHaarEvaluator {
    void dump(FILE* f) {
        for (const auto& ft : features) {
            fprintf(f, "H %d", (int)ft.tilted);
            for (int r = 0; r < 3; r++)
                fprintf(f, " %d %d %d %d %g", ft.rect[r].r.x, ft.rect[r].r.y,
                        ft.rect[r].r.width, ft.rect[r].r.height, ft.rect[r].weight);
            fprintf(f, "\n");
        }
    }
};

struct LBPDumper : CvLBPEvaluator {
    void dump(FILE* f) {
        for (const auto& ft : features)
            fprintf(f, "L %d %d %d %d\n", ft.rect.x, ft.rect.y, ft.rect.width, ft.rect.height);
    }
};

struct HOGDumper : CvHOGEvaluator {
    void dump(FILE* f) {
        for (const auto& ft : features)
            fprintf(f, "G %d %d %d %d\n", ft.rect[0].x, ft.rect[0].y,
                    ft.rect[0].width, ft.rect[0].height);
    }
};

static cv::Mat randomImage(int w, int h, unsigned seed) {
    std::mt19937 rng(seed);
    cv::Mat img(h, w, CV_8UC1);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            img.at<uchar>(y, x) = (uchar)(rng() & 0xff);
    return img;
}

int main(int argc, char** argv) {
    if (argc < 5) {
        fprintf(stderr, "usage: %s <haar|lbp|hog> <w> <h> <geom|resp> [mode]\n", argv[0]);
        return 1;
    }
    const char* family = argv[1];
    int w = atoi(argv[2]), h = atoi(argv[3]);
    bool geom = !strcmp(argv[4], "geom");
    cv::Size win(w, h);

    if (!strcmp(argv[4], "img")) {
        for (int s = 0; s < 4; s++) {
            cv::Mat img = randomImage(w, h, 100 + s);
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++) printf("%d\n", (int)img.at<uchar>(y, x));
        }
        return 0;
    }

    if (!strcmp(family, "haar")) {
        CvHaarFeatureParams p(argc > 5 && !strcmp(argv[5], "ALL")  ? CvHaarFeatureParams::ALL
                              : argc > 5 && !strcmp(argv[5], "CORE") ? CvHaarFeatureParams::CORE
                                                                     : CvHaarFeatureParams::BASIC);
        HaarDumper ev;
        ev.init(&p, 4, win);
        printf("count %d\n", ev.getNumFeatures());
        if (geom) ev.dump(stdout);
        else {
            for (int s = 0; s < 4; s++) ev.setImage(randomImage(w, h, 100 + s), s < 2, s);
            for (int s = 0; s < 4; s++)
                for (int fi = 0; fi < ev.getNumFeatures(); fi++)
                    printf("%.9g\n", ev(fi, s));
        }
    } else if (!strcmp(family, "lbp")) {
        CvLBPFeatureParams p;
        LBPDumper ev;
        ev.init(&p, 4, win);
        printf("count %d\n", ev.getNumFeatures());
        if (geom) ev.dump(stdout);
        else {
            for (int s = 0; s < 4; s++) ev.setImage(randomImage(w, h, 100 + s), s < 2, s);
            for (int s = 0; s < 4; s++)
                for (int fi = 0; fi < ev.getNumFeatures(); fi++)
                    printf("%d\n", (int)ev(fi, s));
        }
    } else {
        CvHOGFeatureParams p;
        HOGDumper ev;
        ev.init(&p, 4, win);
        printf("count %d\n", ev.getNumFeatures());
        if (geom) ev.dump(stdout);
        else {
            for (int s = 0; s < 4; s++) ev.setImage(randomImage(w, h, 100 + s), s < 2, s);
            int vc = ev.getNumFeatures() * 36;
            for (int s = 0; s < 4; s++)
                for (int vi = 0; vi < vc; vi++)
                    printf("%.9g\n", ev(vi, s));
        }
    }
    return 0;
}
